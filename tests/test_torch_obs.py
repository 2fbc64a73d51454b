"""The port's observability: the TensorBoard event writer, the profiler trace, the throughput meter.

- ``obs/tbevents.py`` is the JAX package's writer: the CRC-32C test
  vectors and the record framing of tests/test_tbevents.py, and the same
  bytes as the JAX writer for the same scalar;
- ``TensorBoardLogger`` writes ``Metrics/PSNR`` scalars a reader decodes
  (tag, value, step) by hand;
- ``ThroughputMeter``'s per-card rate divides by the world size; ``trace``
  writes a Chrome trace.
"""

import json
import struct

import torch

from superresolution_def_tpu.obs import tbevents as jax_tbevents
from superresolution_def_tpu_torch.obs import TensorBoardLogger, ThroughputMeter, trace
from superresolution_def_tpu_torch.obs.tbevents import (
    EventFileWriter,
    _crc32c,
    _masked_crc,
    _scalar_event,
)

torch.set_num_threads(1)


def _records(path):
    raw = path.read_bytes()
    off, out = 0, []
    while off < len(raw):
        (length,) = struct.unpack_from("<Q", raw, off)
        (lcrc,) = struct.unpack_from("<I", raw, off + 8)
        assert lcrc == _masked_crc(raw[off:off + 8])
        data = raw[off + 12:off + 12 + length]
        (dcrc,) = struct.unpack_from("<I", raw, off + 12 + length)
        assert dcrc == _masked_crc(data)
        out.append(data)
        off += 12 + length + 4
    return out


def test_crc32c_known_vectors():
    assert _crc32c(b"") == 0x00000000
    assert _crc32c(b"123456789") == 0xE3069283
    assert _crc32c(b"\x00" * 32) == 0x8A9136AA


def test_records_have_valid_framing(tmp_path):
    w = EventFileWriter(tmp_path)
    for i in range(5):
        w.scalar("x", float(i), i)
    w.flush()
    assert len(_records(w.path)) == 6  # the version record + 5 scalars
    assert _scalar_event("Metrics/PSNR", 23.5, 7, 1.25) == jax_tbevents._scalar_event(
        "Metrics/PSNR", 23.5, 7, 1.25)


def test_tensorboard_logger_writes_psnr_scalars(tmp_path):
    tb = TensorBoardLogger(tmp_path / "tensorboard")
    tb.scalar("Metrics/PSNR", 23.45, 1)
    tb.scalar("Metrics/PSNR", 24.5, 2)
    tb.close()
    (path,) = (tmp_path / "tensorboard").glob("events.out.tfevents.*")
    records = _records(path)
    assert b"brain.Event:2" in records[0]
    got = []
    for rec in records[1:]:
        # Event: 1 wall_time (double), 2 step (varint), 5 summary; Summary.Value:
        # 1 tag, 2 simple_value (float)
        assert rec[0] == 0x09 and rec[9] == 0x10
        step = rec[10]
        tag = b"Metrics/PSNR"
        at = rec.index(tag)
        (value,) = struct.unpack_from("<f", rec, at + len(tag) + 1)
        got.append((step, round(value, 4)))
    assert got == [(1, 23.45), (2, 24.5)]


def test_throughput_meter_rate_per_card_divides_by_the_world():
    meter = ThroughputMeter(world_size=4)
    meter.tick(8)  # starts the clock
    meter.tick(8)
    meter.tick(8)
    assert meter.patches == 16 and meter.seconds > 0
    assert meter.patches_per_sec_per_chip == meter.patches_per_sec / 4
    assert ThroughputMeter().world_size == 1  # no process group


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "prof"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
