"""The port's host data path against the JAX package's (PIL decode path)."""

import numpy as np

from superresolution_def_tpu.data import pipeline as jpipeline
from superresolution_def_tpu.data import manifest as jmanifest
from superresolution_def_tpu_torch.data import (
    DataIterator,
    ManifestEntry,
    PatchDataset,
    fix_path,
    load_manifest,
    read_tiff_u16,
    write_manifest,
    write_tiff_u16,
)


def _split(tmp_path, n=5, broken=()):
    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        d = tmp_path / f"p{i}"
        write_tiff_u16(d / "hr.tiff", rng.random((16, 16)))
        write_tiff_u16(d / "lr.tiff", rng.random((4, 4)))
        if i in broken:
            (d / "lr.tiff").write_bytes(b"not a tiff")
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    return entries


def test_tiff_round_trip_quantises_like_the_reference(tmp_path):
    img = np.random.default_rng(1).random((7, 9))
    write_tiff_u16(tmp_path / "a.tiff", img)
    got = read_tiff_u16(tmp_path / "a.tiff")
    assert got.dtype == np.uint16 and got.shape == (7, 9)
    np.testing.assert_array_equal(got, (np.clip(img, 0, 1) * 65535.0).astype(np.uint16))


def test_manifest_matches_jax_schema_and_rerooting(tmp_path):
    entries = _split(tmp_path, n=2)
    write_manifest(tmp_path / "test.json", entries)
    assert load_manifest(tmp_path / "test.json") == entries
    stale = "/old/machine/data/M1/x.tiff"
    assert fix_path(stale, "/new/base") == jmanifest.fix_path(stale, "/new/base")


def test_unreadable_file_is_substituted_like_jax(tmp_path):
    entries = _split(tmp_path, broken={2})
    ours = PatchDataset(entries, lr_size=4, hr_size=16)
    ref = jpipeline.PatchDataset(
        [jmanifest.ManifestEntry(e.patch_id, e.hubble_path, e.ground_path) for e in entries],
        lr_size=4, hr_size=16, use_native=False,
    )
    for i in range(len(entries)):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a["lr"], b["lr"])
        np.testing.assert_array_equal(a["hr"], b["hr"])


def test_iterator_yields_manifest_order_with_wraparound(tmp_path):
    entries = _split(tmp_path, n=5)
    ds = PatchDataset(entries, lr_size=4, hr_size=16)
    batches = list(DataIterator(ds, 2).batches())
    assert [b["lr"].shape for b in batches] == [(2, 4, 4, 1)] * 3
    order = [0, 1, 2, 3, 4, 0]
    got = np.concatenate([b["hr"] for b in batches])
    np.testing.assert_array_equal(got, np.stack([ds[i]["hr"] for i in order]))
