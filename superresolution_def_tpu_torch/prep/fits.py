"""Minimal FITS reader/writer without astropy (a copy of the JAX ``prep/fits.py``).

Supports what the reference pipeline actually uses (Dataset_step1/3): the
primary (or first image) HDU, BITPIX 8/16/32/-32/-64 with BZERO/BSCALE,
NAXIS<=3 (a leading axis is dropped like the reference's `data[0]`), and
ASCII header cards round-tripped as an ordered dict. FITS format per the
public standard: 2880-byte blocks of 80-char cards, big-endian data.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


@dataclasses.dataclass
class FITSImage:
    data: np.ndarray
    header: dict

    @property
    def shape(self):
        return self.data.shape


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        end = raw.rfind("'")
        return raw[1:end].rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        if any(c in raw for c in ".eEdD") and not raw.lstrip("+-").isdigit():
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    except ValueError:
        return raw


def _parse_header(block_bytes: bytes) -> tuple[dict, bool]:
    header: dict = {}
    done = False
    for i in range(0, len(block_bytes), CARD):
        card = block_bytes[i : i + CARD].decode("ascii", errors="replace")
        key = card[:8].strip()
        if key == "END":
            done = True
            break
        if not key or key in ("COMMENT", "HISTORY"):
            continue
        if card[8:10] != "= ":
            continue
        body = card[10:]
        slash = _find_comment_slash(body)
        header[key] = _parse_value(body[:slash] if slash >= 0 else body)
    return header, done


def _find_comment_slash(body: str) -> int:
    in_str = False
    for i, ch in enumerate(body):
        if ch == "'":
            in_str = not in_str
        elif ch == "/" and not in_str:
            return i
    return -1


def read_fits(path: str | Path) -> FITSImage:
    """Read the first image HDU as float32 (+ header)."""
    raw = Path(path).read_bytes()
    pos = 0
    while pos < len(raw):
        header: dict = {}
        done = False
        hstart = pos
        while not done:
            blk = raw[pos : pos + BLOCK]
            if len(blk) < BLOCK:
                raise ValueError(f"{path}: truncated header")
            h, done = _parse_header(blk)
            header.update(h)
            pos += BLOCK
        naxis = int(header.get("NAXIS", 0))
        dims = [int(header.get(f"NAXIS{i}", 0)) for i in range(1, naxis + 1)]
        nelem = int(np.prod(dims)) if dims else 0
        bitpix = int(header.get("BITPIX", 8))
        nbytes = nelem * abs(bitpix) // 8
        if nelem > 0:
            dtype = _BITPIX_DTYPE[bitpix]
            arr = np.frombuffer(raw, dtype=dtype, count=nelem, offset=pos)
            # FITS order: NAXIS1 fastest -> numpy shape reversed
            arr = arr.reshape(dims[::-1]).astype(np.float64)
            bscale = float(header.get("BSCALE", 1.0))
            bzero = float(header.get("BZERO", 0.0))
            if bscale != 1.0 or bzero != 0.0:
                arr = arr * bscale + bzero
            while arr.ndim > 2:  # reference: data[0] on 3-D cubes
                arr = arr[0]
            return FITSImage(arr.astype(np.float32), header)
        # no data in this HDU: skip padding and continue to the next
        pos += ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
        if pos == hstart:
            break
    raise ValueError(f"{path}: no image HDU found")


def _format_card(key: str, value) -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.14G}"
    else:
        s = f"'{str(value):<8}'"
        card = f"{key:<8}= {s:<20}"
    return card.ljust(CARD).encode("ascii")


def write_fits(path: str | Path, data: np.ndarray, header: dict | None = None) -> None:
    """Write a float32 primary-HDU FITS image."""
    data = np.ascontiguousarray(np.asarray(data, np.float32))
    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", -32),
        _format_card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(data.shape[::-1], 1):
        cards.append(_format_card(f"NAXIS{i}", n))
    for k, v in (header or {}).items():
        if k in ("SIMPLE", "BITPIX", "NAXIS") or k.startswith("NAXIS"):
            continue
        cards.append(_format_card(str(k)[:8].upper(), v))
    cards.append(b"END".ljust(CARD))
    head = b"".join(cards)
    head += b" " * (-len(head) % BLOCK)
    body = data.astype(">f4").tobytes()
    body += b"\0" * (-len(body) % BLOCK)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(head + body)
