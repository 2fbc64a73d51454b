"""ctypes binding of the native TIFF codec (the JAX ``data/fast_tiff.py``).

The codec is this package's ``native/tifffast.cpp``: uncompressed 16-bit
single-channel strip TIFFs (PIL's 'I;16', little- or big-endian), single
and threaded-batch decode, and a single-strip little-endian writer. The
first call builds it with g++ into the package's ``_build/`` under a hash of
the source and the flags (``kernels/_build.py``'s naming and rename), and
every later process loads that library; nothing builds at import. A build
or load that fails raises with g++'s stderr: there is no silent fall-back to
PIL. What stays per file, as the JAX wrappers have it, is a return code: a
file whose layout the codec does not read gives ``None`` (or a non-zero
status) and the caller decodes it with PIL.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tifffast.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_DIR: Path | None = None  # None: kernels/_build.py's BUILD_DIR

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# files the codec has decoded in this process (set it to 0 to count a run)
decoded = 0

_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    from ..kernels import _build

    return _build.hashed_path("tifffast", [SOURCE], (CXX, *CXX_FLAGS, "-lpthread"),
                              BUILD_DIR or _build.BUILD_DIR)


def _load() -> ctypes.CDLL:
    """The codec, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            from ..kernels import _build

            path = _build.compile_once(
                library_path(),
                lambda tmp: [CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                f"{CXX} for {SOURCE.name}")
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the TIFF codec {path}: {e}") from e
            lib.tiff_read_u16.restype = ctypes.c_int
            lib.tiff_read_u16.argtypes = [ctypes.c_char_p, _U16P, ctypes.c_int32, ctypes.c_int32]
            lib.tiff_read_batch_u16.restype = None
            lib.tiff_read_batch_u16.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, _U16P, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, _I32P]
            lib.tiff_write_u16.restype = ctypes.c_int
            lib.tiff_write_u16.argtypes = [ctypes.c_char_p, _U16P, ctypes.c_int32,
                                           ctypes.c_int32]
            _lib = lib
    return _lib


def native_available() -> bool:
    """True once the codec is loaded; raises when it cannot be built or loaded."""
    _load()
    return True


def _count(n: int) -> None:
    global decoded
    with _lock:
        decoded += n


def read_tiff_u16_native(path: str | Path, h: int, w: int) -> np.ndarray | None:
    """Decode one (h, w) file; None where the codec does not read it (PIL then)."""
    out = np.empty((h, w), np.uint16)
    rc = _load().tiff_read_u16(str(path).encode(), out.ctypes.data_as(_U16P), h, w)
    if rc != 0:
        return None
    _count(1)
    return out


def read_batch_u16(paths: list, h: int, w: int,
                   nthreads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Threaded decode -> (batch (N, h, w) uint16, status (N,) int32, 0 = decoded)."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, h, w), np.uint16)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.tiff_read_batch_u16(arr, n, out.ctypes.data_as(_U16P), h, w, nthreads,
                            status.ctypes.data_as(_I32P))
    _count(int((status == 0).sum()))
    return out, status


def write_u16_native(path: str | Path, u16: np.ndarray) -> bool:
    """Write an already-quantized (H, W) uint16 array; False: the file could
    not be opened (the caller writes it with PIL)."""
    u16 = np.ascontiguousarray(u16, dtype=np.uint16)
    rc = _load().tiff_write_u16(str(path).encode(), u16.ctypes.data_as(_U16P), u16.shape[0],
                                u16.shape[1])
    return rc == 0


def write_tiff_u16_native(path: str | Path, img01: np.ndarray) -> bool:
    """Quantize a [0, 1] image to uint16 and write it natively."""
    u16 = (np.clip(np.asarray(img01, np.float64), 0.0, 1.0) * 65535.0).astype(np.uint16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    return write_u16_native(path, u16)
