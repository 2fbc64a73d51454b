"""Minimal TensorBoard event-file writer — zero dependencies.

The port's copy of the JAX package's ``obs/tbevents.py`` (standard library
only).

Writes scalar summaries in the tfevents format TensorBoard reads, like the
reference's torch.utils.tensorboard SummaryWriter (train_swin.py:118,305)
which also needs no TensorFlow. Hand-encodes the two protobufs involved
(Event, Summary) and the TFRecord framing (length + masked CRC32C).

Record framing (tensorflow/core/lib/io/record_writer):
  uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)

Event proto fields used: 1 wall_time (double), 2 step (int64),
3 file_version (string, first record only), 5 summary (Summary).
Summary: repeated 1 value; Summary.Value: 1 tag (string),
2 simple_value (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# --- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    _CRC_TABLE = tbl
    return tbl


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- tiny protobuf encoders ---------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_pb = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary_pb = _field_bytes(1, value_pb)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary_pb)
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class EventFileWriter:
    """Append-only tfevents writer for scalar summaries."""

    def __init__(self, log_dir: str | Path):
        d = Path(log_dir)
        d.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "host"
        name = f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
        self.path = d / name
        self._f = open(self.path, "ab")
        self._record(_version_event(time.time()))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(tag, value, step, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
