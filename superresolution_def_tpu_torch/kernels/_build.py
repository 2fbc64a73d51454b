"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` inside the package (``.gitignore`` lists
the directory). The hash covers the source, the shared ``csrc/*.cuh``
headers and the compiler flags, so an edited source is rebuilt on its next
load and an unchanged one is reused. Nothing here runs at import time: the
first :func:`load_library` (or :func:`build_all`) call builds.
:func:`hashed_path` and :func:`compile_once` also build the native TIFF
codec with g++ (``data/fast_tiff.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT / "_build"

# sm_90a (not sm_90): the arch-specific target that later wgmma/TMA work needs
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit that PyTorch located."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: install the CUDA toolkit or put nvcc on PATH")


def hashed_path(stem: str, inputs, flags, build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/lib<stem>-<hash>.so``: the hash covers the bytes of each of
    ``inputs`` in order and the compiler flags, never a file's mtime."""
    h = hashlib.sha256()
    for path in inputs:
        h.update(Path(path).read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"lib{stem}-{h.hexdigest()[:16]}.so"


def compile_once(out: Path, command, what: str) -> Path:
    """Run ``command(tmp)`` (the compiler line writing ``tmp``) unless ``out``
    exists, then rename ``tmp`` to ``out``; raises with the compiler's stderr."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = command(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library_path(name: str) -> Path:
    return hashed_path(name, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    return compile_once(library_path(name),
                        lambda tmp: [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                        f"nvcc for {name}.cu")


def build_all(names) -> list[Path]:
    """Build several sources at once, one nvcc process each."""
    names = list(names)
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def build_log(name: str) -> str:
    """Compiler output of the current build of ``name`` (ptxas statistics)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
