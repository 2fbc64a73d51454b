"""The port's synthetic skies and native TIFF codec against the JAX package's.

- ``data/synth.py``: the same seed gives the JAX package's arrays, bit for bit.
- ``data/fast_tiff.py`` (the port's own ``native/tifffast.cpp``, built with
  g++ into a hashed ``_build/`` library at first use): native decodes equal
  the JAX package's PIL reader, PIL reads the native writes, the batch
  decoder's per-file status codes, and the dataset and iterator give the
  same batches with the codec on and off (PIL per file where it does not
  read one). The JAX ``fast_tiff`` is never called: it rebuilds the
  repository's ``native/libtifffast.so`` by mtime.
- The build: a second process loads the library the first built without
  compiling, and a build that fails raises with g++'s stderr (no silent
  fall-back to PIL). Both in a temporary build directory.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from superresolution_def_tpu.data import manifest as jmanifest
from superresolution_def_tpu.data import pipeline as jpipeline
from superresolution_def_tpu.data import synth as jsynth
from superresolution_def_tpu.data import tiff as jtiff
from superresolution_def_tpu_torch.data import (
    DataIterator,
    ManifestEntry,
    PatchDataset,
    fast_tiff,
    synth_batch_u16,
    synth_pair,
    write_tiff_u16,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synth_matches_jax_bit_for_bit(seed):
    hr, lr = synth_pair(np.random.default_rng(seed), hr_size=64)
    jhr, jlr = jsynth.synth_pair(np.random.default_rng(seed), hr_size=64)
    assert hr.dtype == np.float32 and hr.shape == (64, 64) and lr.shape == (16, 16)
    np.testing.assert_array_equal(hr, jhr)
    np.testing.assert_array_equal(lr, jlr)
    ours, ref = synth_batch_u16(3, 64, seed=seed), jsynth.synth_batch_u16(3, 64, seed=seed)
    assert ours["hr"].shape == (3, 64, 64, 1) and ours["lr"].dtype == np.uint16
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(ours[k], ref[k])


def _u16(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 65536, shape, dtype=np.uint16)


@pytest.mark.parametrize("shape", [(16, 16), (7, 9), (512, 512), (3, 130)])
def test_native_read_equals_the_jax_pil_reader(tmp_path, shape):
    want = _u16(shape)
    path = tmp_path / "pil.tiff"
    Image.fromarray(want).save(str(path))  # PIL 'I;16'
    got = fast_tiff.read_tiff_u16_native(path, *shape)
    np.testing.assert_array_equal(got, jtiff.read_tiff_u16(path))
    np.testing.assert_array_equal(got, want)


def test_pil_reads_the_native_writes(tmp_path):
    want = _u16((20, 36), seed=1)
    assert fast_tiff.write_u16_native(tmp_path / "a.tiff", want)
    np.testing.assert_array_equal(jtiff.read_tiff_u16(tmp_path / "a.tiff"), want)
    img = np.random.default_rng(2).random((9, 11)) * 1.2 - 0.1  # clipped to [0, 1]
    write_tiff_u16(tmp_path / "b" / "b.tiff", img)  # data/tiff.py, through the codec
    assert fast_tiff.write_tiff_u16_native(tmp_path / "c" / "c.tiff", img)
    jtiff.write_tiff_u16(tmp_path / "j.tiff", img)  # the JAX writer's quantization
    want = jtiff.read_tiff_u16(tmp_path / "j.tiff")
    for p in (tmp_path / "b" / "b.tiff", tmp_path / "c" / "c.tiff"):
        np.testing.assert_array_equal(jtiff.read_tiff_u16(p), want)
        assert Image.open(p).mode == "I;16"


def _big_endian(path, arr):
    Image.frombytes("I;16B", arr.shape[::-1], arr.astype(">u2").tobytes()).save(str(path))
    assert path.read_bytes()[:2] == b"MM"


def test_read_batch_status_codes(tmp_path):
    good = [_u16((8, 8), seed=s) for s in range(3)]
    paths = []
    for i, a in enumerate(good):
        paths.append(tmp_path / f"g{i}.tiff")
        fast_tiff.write_u16_native(paths[-1], a)
    (tmp_path / "bad.tiff").write_bytes(b"not a tiff at all")
    fast_tiff.write_u16_native(tmp_path / "wide.tiff", _u16((8, 9)))
    _big_endian(tmp_path / "be.tiff", good[1])
    paths += [tmp_path / "bad.tiff", tmp_path / "missing.tiff", tmp_path / "wide.tiff",
              tmp_path / "be.tiff"]
    batch, status = fast_tiff.read_batch_u16(paths, 8, 8, nthreads=3)
    assert batch.shape == (7, 8, 8) and batch.dtype == np.uint16
    # 0 decoded, -2 not a TIFF, -1 unreadable, -4 another shape
    assert status.tolist() == [0, 0, 0, -2, -1, -4, 0]
    for j in (0, 1, 2):
        np.testing.assert_array_equal(batch[j], good[j])
    np.testing.assert_array_equal(batch[6], good[1])
    assert fast_tiff.read_tiff_u16_native(tmp_path / "wide.tiff", 8, 8) is None


def _entries(tmp_path, n=7):
    """n pairs at 16/4, pair 2's LR garbage, pair 4's HR another shape and
    pair 5's LR big-endian."""
    rng = np.random.default_rng(3)
    entries = []
    for i in range(n):
        d = tmp_path / f"p{i}"
        write_tiff_u16(d / "hr.tiff", rng.random((12 if i == 4 else 16, 16)))
        lr = rng.random((4, 4))
        write_tiff_u16(d / "lr.tiff", lr)
        if i == 2:
            (d / "lr.tiff").write_bytes(b"garbage")
        if i == 5:
            _big_endian(d / "lr.tiff", (lr * 65535).astype(np.uint16))
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    return entries


def test_dataset_and_iterator_batches_equal_with_the_codec_on_and_off(tmp_path):
    entries = _entries(tmp_path)
    native, pil = PatchDataset(entries, 4, 16), PatchDataset(entries, 4, 16, use_native=False)
    assert native.use_native and not pil.use_native
    ref = jpipeline.PatchDataset(
        [jmanifest.ManifestEntry(e.patch_id, e.hubble_path, e.ground_path) for e in entries],
        lr_size=4, hr_size=16, use_native=False)
    for i in range(len(entries)):  # per file: PIL where the codec returns non-zero
        for k in ("lr", "hr"):
            np.testing.assert_array_equal(native[i][k], pil[i][k])
            np.testing.assert_array_equal(native[i][k], ref[i][k])
    idxs = [0, 2, 4, 5, 6, 1]
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(native.read_batch(idxs)[k], pil.read_batch(idxs)[k])
    for kw in (dict(shuffle=True, drop_last=True, seed=5),
               dict(shuffle=True, process_index=1, process_count=2, seed=1), {}):
        got = list(DataIterator(native, 2, **kw).epoch(3))
        want = list(DataIterator(pil, 2, **kw).epoch(3))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for k in ("lr", "hr"):
                np.testing.assert_array_equal(a[k], b[k])


LOAD = textwrap.dedent(
    """
    import subprocess, sys
    from pathlib import Path
    import numpy as np
    from superresolution_def_tpu_torch.data import fast_tiff
    fast_tiff.BUILD_DIR = Path(sys.argv[1])
    if sys.argv[2] == "no-compiler":
        def refuse(*a, **k):
            raise AssertionError(f"compiled again: {a}")
        subprocess.run = refuse
    assert fast_tiff.native_available()
    a = np.arange(12, dtype=np.uint16).reshape(3, 4)
    assert fast_tiff.write_u16_native(Path(sys.argv[1]) / "t.tiff", a)
    assert (fast_tiff.read_tiff_u16_native(Path(sys.argv[1]) / "t.tiff", 3, 4) == a).all()
    print(fast_tiff.library_path().name)
    """
)


def test_a_second_process_loads_the_library_without_rebuilding(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    names = []
    for mode in ("build", "no-compiler"):
        proc = subprocess.run([sys.executable, "-c", LOAD, str(tmp_path), mode], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        names.append(proc.stdout.split()[-1])
    assert names[0] == names[1] and names[0].startswith("libtifffast-")
    assert sorted(p.name for p in tmp_path.glob("*.so")) == [names[0]]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(fast_tiff, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(fast_tiff, "_lib", None)
    monkeypatch.setattr(fast_tiff, "CXX_FLAGS", (*fast_tiff.CXX_FLAGS, "-fno-such-flag-at-all"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ for tifffast.cpp failed.*no-such-flag"):
        fast_tiff.native_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ for tifffast.cpp failed"):
        PatchDataset([], 4, 16)
    assert list(tmp_path.glob("*.so")) == []  # no half-built library left behind
