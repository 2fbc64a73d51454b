"""The port's dataset prep against the JAX package's, on the same files.

Tolerances:
- FITS, WCS, sampling grids, the stride rule, the split, the host-side HR
  stats: the same numpy code on both sides, so exact;
- reprojection: float32 bilinear weights in the same order, atol 1e-6 and
  the same NaN footprint;
- percentiles and normalized values: float32 sort and arithmetic on both
  sides, rtol 1e-6;
- uint16 TIFFs: a float32 ULP of log1p or of the affine map may move a value
  across a code boundary, so codes agree to 1 LSB.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superresolution_def_tpu.prep as jprep
import superresolution_def_tpu_torch.prep as tprep
from superresolution_def_tpu.data import split_pairs as jax_split_pairs
from superresolution_def_tpu.data.tiff import read_tiff_u16
from superresolution_def_tpu.ops import normalize as jnorm
from superresolution_def_tpu_torch.cli.main import main as cli_main
from superresolution_def_tpu_torch.data import ManifestEntry, split_pairs
from superresolution_def_tpu_torch.ops import normalize as tnorm

CPU = dict(device="cpu")
QUIET = dict(log=lambda *a: None)
# the small sky: HR 512² at 2e-4 deg/px, the observatory frame 128² at 4x
# the scale; hr 128, lr 32, stride 64 -> 49 candidates
SIZE, SCALE = 512, 2e-4
CUT = dict(stride=64, hr_size=128, lr_size=32)


def _wcs(mod, scale=1e-3, crval=(10.0, 20.0), crpix=(50.0, 50.0)):
    return mod.TanWCS(crval, crpix, cdelt=[-scale, scale])


def _sip_header():
    h = _wcs(jprep, 2e-4).to_header()
    h.update({"A_ORDER": 2, "B_ORDER": 2, "A_2_0": 1e-6, "A_0_2": -2e-6, "A_1_1": 5e-7,
              "B_2_0": -1e-6, "B_0_2": 3e-6, "B_1_1": 2e-7})
    return h


def _assert_fits_equal(a_path, b_path, atol=0.0):
    a, b = jprep.read_fits(a_path), tprep.read_fits(b_path)
    np.testing.assert_allclose(b.data, a.data, rtol=0, atol=atol)
    assert b.header == a.header


def _assert_tiff_1lsb(a_path, b_path):
    a = read_tiff_u16(a_path).astype(np.int64)
    b = read_tiff_u16(b_path).astype(np.int64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1, (a_path, np.abs(a - b).max())


# --------------------------------------------------------------------------- #
# FITS and WCS (the cases of tests/test_prep.py:26-155): numpy copies, exact
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fits_roundtrip_across_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((37, 53)).astype(np.float32)
    hdr = {"OBJECT": "M42 field", "EXPTIME": 12.5, "GAIN": 3, "FLAG": True,
           **_wcs(jprep).to_header()}
    (jprep if writer == "jax" else tprep).write_fits(tmp_path / "a.fits", data, hdr)
    for mod in (jprep, tprep):
        img = mod.read_fits(tmp_path / "a.fits")
        np.testing.assert_array_equal(img.data, data)
        assert img.header["OBJECT"] == "M42 field" and img.header["GAIN"] == 3
    assert tprep.read_fits(tmp_path / "a.fits").header == jprep.read_fits(tmp_path / "a.fits").header
    assert (tmp_path / "a.fits").stat().st_size % 2880 == 0


def test_fits_bitpix16_bscale_and_cube(tmp_path):
    """BITPIX 16 with BZERO/BSCALE, and a 3-D cube read as its first plane."""
    import struct

    vals = np.arange(-6, 6, dtype=">i2").reshape(2, 2, 3)
    cards = ["SIMPLE  =                    T", "BITPIX  =                   16",
             "NAXIS   =                    3", "NAXIS1  =                    3",
             "NAXIS2  =                    2", "NAXIS3  =                    2",
             "BZERO   =              32768.0", "BSCALE  =                  0.5", "END"]
    head = b"".join(c.ljust(80).encode() for c in cards)
    head += b" " * (-len(head) % 2880)
    body = struct.pack(">12h", *vals.ravel().tolist())
    body += b"\0" * (-len(body) % 2880)
    (tmp_path / "c.fits").write_bytes(head + body)
    a, b = jprep.read_fits(tmp_path / "c.fits"), tprep.read_fits(tmp_path / "c.fits")
    np.testing.assert_array_equal(b.data, a.data)
    np.testing.assert_array_equal(b.data, vals[0].astype(np.float64) * 0.5 + 32768.0)


def test_wcs_transforms_match():
    rng = np.random.default_rng(1)
    px, py = rng.uniform(-20, 120, 200), rng.uniform(-20, 120, 200)
    wj, wt = _wcs(jprep), _wcs(tprep)
    ra_j, dec_j = wj.pixel_to_world(px, py)
    ra_t, dec_t = wt.pixel_to_world(px, py)
    np.testing.assert_array_equal(ra_t, ra_j)
    np.testing.assert_array_equal(dec_t, dec_j)
    np.testing.assert_array_equal(np.stack(wt.world_to_pixel(ra_t, dec_t)),
                                  np.stack(wj.world_to_pixel(ra_j, dec_j)))
    np.testing.assert_allclose(np.stack(wt.world_to_pixel(ra_t, dec_t)), np.stack([px, py]),
                               atol=1e-8)
    for a, b in ((wj.slice(7, 11), wt.slice(7, 11)), (wj.scaled_lr(4.0), wt.scaled_lr(4.0))):
        assert b.to_header() == a.to_header()
    assert wt.pixel_scale_arcsec() == wj.pixel_scale_arcsec()
    assert wt.center_world((100, 80)) == wj.center_world((100, 80))
    reg_j = jprep.TanWCS.registration_target((30.0, 45.0), (200, 300), 1e-4)
    reg_t = tprep.TanWCS.registration_target((30.0, 45.0), (200, 300), 1e-4)
    assert reg_t.to_header() == reg_j.to_header()
    assert tprep.TanWCS.from_header(reg_j.to_header()).to_header() == reg_j.to_header()
    assert (tprep.angular_separation_deg(10.0, 20.0, 10.5, 20.3)
            == jprep.angular_separation_deg(10.0, 20.0, 10.5, 20.3))


def test_wcs_sip_matches_and_guards():
    hdr = _sip_header()
    wj, wt = jprep.TanWCS.from_header(hdr), tprep.TanWCS.from_header(hdr)
    assert wt.has_sip and wt.to_header() == wj.to_header()
    rng = np.random.default_rng(2)
    px, py = rng.uniform(0, 100, 50), rng.uniform(0, 100, 50)
    ra, dec = wt.pixel_to_world(px, py)
    np.testing.assert_array_equal(np.stack([ra, dec]), np.stack(wj.pixel_to_world(px, py)))
    # no AP/BP: the inverse iterates on the forward polynomials
    back = np.stack(wt.world_to_pixel(ra, dec))
    np.testing.assert_array_equal(back, np.stack(wj.world_to_pixel(ra, dec)))
    np.testing.assert_allclose(back, np.stack([px, py]), atol=1e-7)
    for op in (lambda w: w.slice(1, 2), lambda w: w.scaled_lr(4.0)):
        with pytest.raises(ValueError, match="SIP"):
            op(wt)


# --------------------------------------------------------------------------- #
# reprojection and normalization on tensors
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fill_nan", [True, False])
def test_reproject_matches_jax(fill_nan):
    rng = np.random.default_rng(3)
    data = rng.random((40, 50)).astype(np.float32)
    src = _wcs(jprep, 1e-3, crpix=(25.0, 20.0))
    # shifted, finer and partly outside the source: NaN (or 0) at the edges
    dsts = [_wcs(jprep, 7e-4, crval=(10.0 + 0.008 * i, 20.0 - 0.008 * i), crpix=(12.0, 9.0))
            for i in range(5)]
    single_j = jprep.reproject_bilinear(data, src, dsts[0], (24, 30), fill_nan=fill_nan)
    single_t = tprep.reproject_bilinear(data, src, dsts[0], (24, 30), fill_nan=fill_nan, **CPU)
    batch_j = jprep.reproject_batch(data, src, dsts, (24, 30), fill_nan=fill_nan)
    batch_t = tprep.reproject_batch(data, src, dsts, (24, 30), fill_nan=fill_nan, **CPU)
    for got, want in ((single_t, single_j), (batch_t, batch_j)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, equal_nan=True)
    outside = np.isnan(batch_j) if fill_nan else batch_j == 0
    assert 0 < outside.mean() < 0.9  # the footprint edge is exercised


def test_normalize_ops_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.gamma(2.0, 0.2, (96, 80)) * (rng.random((96, 80)) > 0.2)).astype(np.float32)
    x[:3] = -0.5  # below the valid floor
    lo_j, hi_j = jnorm.robust_minmax(jnp.asarray(x))
    lo_t, hi_t = tnorm.robust_minmax(x, **CPU)
    np.testing.assert_allclose([float(lo_t), float(hi_t)], [float(lo_j), float(hi_j)], rtol=1e-6)
    # the float32 position, as the JAX fused path computes it, and numpy's
    valid = x > jnorm.MIN_VALID_PIXEL
    np.testing.assert_allclose([float(lo_t), float(hi_t)],
                               np.percentile(np.log1p(x[valid]), (4.0, 99.99)), rtol=1e-5)
    for lo, hi in ((lo_j, hi_j), (0.02, 0.9)):  # device stats and Python floats
        want = np.asarray(jnorm.log_stretch_normalize(jnp.asarray(x), lo, hi))
        lt, ht = (lo_t, hi_t) if not isinstance(lo, float) else (lo, hi)
        got = tnorm.log_stretch_normalize(x, lt, ht, **CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        code_j = np.asarray(jnorm.quantize_u16(jnp.asarray(want))).astype(np.int64)
        code_t = tnorm.quantize_u16(torch.from_numpy(got), **CPU)
        assert code_t.dtype == torch.int32
        assert np.abs(code_t.numpy().astype(np.int64) - code_j).max() <= 1
    # truncation toward zero, and the clip, exactly the JAX convert's
    edge = np.array([0.0, 1.0, 0.5, 1.5, -0.2, 1 / 65535 - 1e-9], np.float32)
    np.testing.assert_array_equal(tnorm.quantize_u16(edge).numpy(),
                                  np.asarray(jnorm.quantize_u16(jnp.asarray(edge))))


def test_masked_percentiles_match_the_jax_fused_program():
    import superresolution_def_tpu.prep.fused as jfused

    rng = np.random.default_rng(5)
    v = rng.random((7, 33)).astype(np.float32)
    mask = rng.random((7, 33)) > 0.3
    want = jfused._masked_percentiles(jnp.asarray(v), jnp.asarray(mask), (4.0, 99.99))
    got = tnorm.masked_percentiles(torch.from_numpy(v), torch.from_numpy(mask), (4.0, 99.99))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)


# --------------------------------------------------------------------------- #
# steps 3 and 4, staged and fused, against the JAX functions
# --------------------------------------------------------------------------- #
def _write_sky(root, rng_seed=0, size=SIZE, half_valid=False):
    rng = np.random.default_rng(rng_seed)
    sky = (rng.random((size, size)) * 0.6 + 0.2).astype(np.float32)
    if half_valid:
        sky[size // 2:] = 0.0
    w_h = jprep.TanWCS((10.0, 20.0), (size / 2, size / 2), cdelt=[-SCALE, SCALE])
    (root / "hub").mkdir(parents=True)
    (root / "obs").mkdir()
    jprep.write_fits(root / "hub" / "reg_h.fits", sky, w_h.to_header())
    w_o = jprep.TanWCS((10.0, 20.0), (size / 8, size / 8), cdelt=[-SCALE * 4, SCALE * 4])
    obs = np.nan_to_num(jprep.reproject_bilinear(sky, w_h, w_o, (size // 4, size // 4)))
    jprep.write_fits(root / "obs" / "reg_o.fits", obs, w_o.to_header())
    # a frame far from the field is distance-filtered out
    w_far = jprep.TanWCS((50.0, -10.0), (16.0, 16.0), cdelt=[-SCALE * 4, SCALE * 4])
    jprep.write_fits(root / "obs" / "reg_zfar.fits", np.ones((32, 32), np.float32),
                     w_far.to_header())
    return root


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    return _write_sky(tmp_path_factory.mktemp("sky"))


@pytest.fixture(scope="module")
def sky2(tmp_path_factory, sky):
    """Two observatory frames of one target, the second at half intensity."""
    root = tmp_path_factory.mktemp("sky2") / "s"
    shutil.copytree(sky, root)
    a = jprep.read_fits(root / "obs" / "reg_o.fits")
    jprep.write_fits(root / "obs" / "reg_o2.fits", a.data * 0.5, a.header)
    return root


def _compare_outputs(jax_pairs, port_pairs, jax_ready, port_ready, n):
    names = sorted(p.name for p in port_pairs.glob("pair_*"))
    assert names == sorted(p.name for p in jax_pairs.glob("pair_*"))
    assert len(names) == n
    for name in names:
        for f in ("hubble.fits", "observatory.fits"):
            _assert_fits_equal(jax_pairs / name / f, port_pairs / name / f, atol=1e-6)
        for f in ("hubble.tiff", "observatory.tiff"):
            _assert_tiff_1lsb(jax_ready / name / f, port_ready / name / f)


@pytest.mark.parametrize("frames", ["one", "two"])
def test_staged_prep_matches_jax(sky, sky2, tmp_path, frames):
    src = sky if frames == "one" else sky2
    n_j = jprep.extract_patches(src / "hub", src / "obs", tmp_path / "pj", **CUT, **QUIET)
    m_j = jprep.normalize_target(tmp_path / "pj", tmp_path / "rj", **QUIET)
    n_t = tprep.extract_patches(src / "hub", src / "obs", tmp_path / "pt", **CUT, **QUIET, **CPU)
    m_t = tprep.normalize_target(tmp_path / "pt", tmp_path / "rt", **QUIET, **CPU)
    assert n_t == m_t == n_j == m_j == 49 * (1 if frames == "one" else 2)
    _compare_outputs(tmp_path / "pj", tmp_path / "pt", tmp_path / "rj", tmp_path / "rt", n_t)


def test_robust_stats_sample_the_same_pixels(sky, tmp_path):
    """Pass 1 draws with the same seeded generator: identical pools, so the
    stats agree to float32 sorting precision."""
    jprep.extract_patches(sky / "hub", sky / "obs", tmp_path / "p", **CUT, **QUIET)
    paths = sorted((tmp_path / "p").glob("pair_*/hubble.fits"))
    want = jprep.calculate_robust_stats(paths, **QUIET)
    got = tprep.calculate_robust_stats(paths, **QUIET, **CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("case", ["one-frame", "two-frames", "low-coverage"])
def test_fused_prep_matches_jax(sky, sky2, tmp_path, case):
    """Pair names, FITS pairs and headers, TIFFs to 1 LSB; with two frames
    the stats are per target (the x0.5 frame comes out darker); with half
    the sky empty the low-coverage candidates are dropped on both sides."""
    src = {"one-frame": sky, "two-frames": sky2}.get(case)
    if src is None:
        src = _write_sky(tmp_path / "half", half_valid=True)
    n_j = jprep.fused_prep_target(src / "hub", src / "obs", tmp_path / "pj", tmp_path / "rj",
                                  **CUT, **QUIET)
    stats = {}
    n_t = tprep.fused_prep_target(src / "hub", src / "obs", tmp_path / "pt", tmp_path / "rt",
                                  **CUT, **QUIET, **CPU, stats=stats)
    assert n_t == n_j > 0
    _compare_outputs(tmp_path / "pj", tmp_path / "pt", tmp_path / "rj", tmp_path / "rt", n_t)
    assert set(stats) == {"hr", "lr", "phases"} and stats["phases"]["total"] > 0
    if case == "two-frames":
        assert n_t == 2 * 49
        obs = [read_tiff_u16(tmp_path / "rt" / f"pair_{i:06d}" / "observatory.tiff").mean()
               for i in range(n_t)]
        assert np.mean(obs[49:]) < 0.75 * np.mean(obs[:49])
    if case == "low-coverage":
        n_staged = jprep.extract_patches(src / "hub", src / "obs", tmp_path / "ps", **CUT, **QUIET)
        assert n_t == n_staged < 49


def test_fused_prep_without_fits_pairs(sky, tmp_path):
    n = tprep.fused_prep_target(sky / "hub", sky / "obs", tmp_path / "p", tmp_path / "r",
                                **CUT, **QUIET, **CPU, write_fits_pairs=False)
    assert n == 49 and not list((tmp_path / "p").glob("pair_*"))
    assert len(list((tmp_path / "r").glob("pair_*/observatory.tiff"))) == 49


def test_stride_rule_matches():
    for name, want in (("M1_data", None), ("M1_data", 850), ("M82_x", 5600), ("unknown", 500),
                       ("M8", 100000), ("NGC_M42", 300)):
        assert (tprep.calculate_stride_for_target(name, want)
                == jprep.calculate_stride_for_target(name, want))


# --------------------------------------------------------------------------- #
# the split, registration, logging, the CLI
# --------------------------------------------------------------------------- #
def test_split_pairs_matches_jax():
    from superresolution_def_tpu.data import ManifestEntry as JEntry

    for n in (0, 1, 7, 23):
        ents = [(f"pair_{i:06d}", f"/d/h{i}.tiff", f"/d/g{i}.tiff") for i in range(n)]
        got = split_pairs([ManifestEntry(*e) for e in ents])
        want = jax_split_pairs([JEntry(*e) for e in ents])
        assert {k: [e.to_json() for e in v] for k, v in got.items()} == \
            {k: [e.to_json() for e in v] for k, v in want.items()}


def test_prepare_full_dataset_matches_jax(sky, tmp_path):
    jprep.fused_prep_target(sky / "hub", sky / "obs", tmp_path / "T" / "6_patches_final",
                            tmp_path / "T" / "7_dataset_ready_LOG", **CUT, **QUIET)
    shutil.copytree(tmp_path / "T", tmp_path / "U")
    want = jprep.prepare_full_dataset(tmp_path / "T")
    got = cli_main(["split", "--data-root", str(tmp_path), "--target", "U"])["U"]
    assert got == want == {"train": 39, "val": 4, "test": 6}
    for split in ("train", "val", "test"):
        j = json.loads((tmp_path / "T" / "8_dataset_split" / "splits_json" / f"{split}.json")
                       .read_text())
        t = json.loads((tmp_path / "U" / "8_dataset_split" / "splits_json" / f"{split}.json")
                       .read_text())
        assert t == [{k: v.replace(str(tmp_path / "T"), str(tmp_path / "U")) for k, v in e.items()}
                     for e in j]


def test_registration_matches_jax(tmp_path):
    """Step 1 on solved frames: the already-solved path needs no ASTAP, and
    the registered frames agree with the JAX package's to atol 1e-6."""
    rng = np.random.default_rng(3)
    size, scale = 96, 1e-4
    sky = rng.random((size, size)).astype(np.float32)
    w_h = jprep.TanWCS((30.0, 45.0), (size / 2, size / 2), cdelt=[-scale, scale])
    w_o = jprep.TanWCS((30.001, 45.001), (size / 2, size / 2), cdelt=[-scale, scale])
    orig = tmp_path / "orig"
    jprep.write_fits(orig / "h" / "a.fits", sky, w_h.to_header())
    jprep.write_fits(orig / "o" / "b.fits", sky, w_o.to_header())
    jprep.write_fits(orig / "o" / "nowcs.fits", sky, {})  # unsolved; no ASTAP binary here
    out = {}
    for side, mod, kw in (("j", jprep, {}), ("t", tprep, CPU)):
        sh = mod.process_step1_folder(orig / "h", tmp_path / side / "sh", astap="/nonexistent",
                                      **QUIET)
        so = mod.process_step1_folder(orig / "o", tmp_path / side / "so", astap="/nonexistent",
                                      **QUIET)
        assert [p.name for p in sh] == ["a_solved.fits"] and [p.name for p in so] == [
            "b_solved.fits"]
        out[side] = mod.main_registration(tmp_path / side / "sh", tmp_path / side / "so",
                                          tmp_path / side / "rh", tmp_path / side / "ro",
                                          **QUIET, **kw)
    assert out["t"] == out["j"] == {"ok": 2, "err": 0}
    for d, f in (("rh", "reg_a_solved.fits"), ("ro", "reg_b_solved.fits")):
        a = jprep.read_fits(tmp_path / "j" / d / f)
        b = tprep.read_fits(tmp_path / "t" / d / f)
        assert b.header == a.header and b.header["REG_METH"] == "ASTAP_SOLVE+REPROJECT"
        np.testing.assert_array_equal(np.isnan(b.data), np.isnan(a.data))
        np.testing.assert_allclose(b.data, a.data, rtol=0, atol=1e-6, equal_nan=True)


def test_prep_logger_and_artifacts(sky, tmp_path):
    """The timestamped log, the staged steps' debug cards and zips
    (Dataset_step1:44-54, Dataset_step3:431-435, Dataset_step4:179-189)."""
    log, path = tprep.make_prep_logger(tmp_path / "logs", prefix="prep")
    log("hello step")
    assert path.name.startswith("prep_") and path.read_text().rstrip().endswith(" - hello step")
    t = tmp_path / "t"
    n = tprep.extract_patches(sky / "hub", sky / "obs", t / "6_patches_final", stride=192,
                              hr_size=128, lr_size=32, target_name="t",
                              debug_dir=t / "dbg3", debug_samples=2, zip_outputs=True, log=log,
                              **CPU)
    m = tprep.normalize_target(t / "6_patches_final", t / "7_dataset_ready_LOG",
                               debug_dir=t / "dbg4", debug_interval=1, zip_debug=True, log=log,
                               **CPU)
    assert n == m == 9
    assert len(list((t / "dbg3").glob("*_card.png"))) == 2
    assert len(list((t / "dbg4").glob("check_pair_*.png"))) == 9
    for z in ("t_patches.zip", "t_debug_visuals.zip", "debug_checks_clip_4.0.zip"):
        assert (t / z).exists()
    assert "[step3]" in path.read_text() and "[step4]" in path.read_text()


def test_mosaic_matches_jax(sky, tmp_path):
    """Step 2's canvas: the Hubble frames reprojected onto the observatory
    grid agree with the JAX package's (atol 1e-6); the figure is drawn."""
    shutil.copytree(sky / "hub", tmp_path / "hub")
    (tmp_path / "obs").mkdir()
    shutil.copy(sky / "obs" / "reg_o.fits", tmp_path / "obs")
    sky = tmp_path  # the median stack takes frames of one shape: no far frame
    master_j, w_j = jprep.mosaic.load_observatory_master(sky / "obs")
    master_t, w_t = tprep.mosaic.load_observatory_master(sky / "obs")
    np.testing.assert_array_equal(master_t, master_j)
    want = jprep.mosaic.create_hubble_mosaic(sky / "hub", w_j, master_j.shape)
    got = tprep.mosaic.create_hubble_mosaic(sky / "hub", w_t, master_t.shape, "cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, equal_nan=True)
    assert tprep.mosaic_check(sky / "hub", sky / "obs", tmp_path / "m.png", **QUIET, **CPU)
    assert (tmp_path / "m.png").stat().st_size > 0


def _solved_target(root, name="SYN", seed=5, size=640):
    """A target whose raw frames carry solved TAN headers (no ASTAP needed);
    at the CLI's hr 512, lr 128 and stride 40, 16 candidates."""
    rng = np.random.default_rng(seed)
    sky = (rng.random((size, size)) * 0.6 + 0.2).astype(np.float32)
    w_h = jprep.TanWCS((10.0, 20.0), (size / 2, size / 2), cdelt=[-SCALE, SCALE])
    w_o = jprep.TanWCS((10.0, 20.0), (size / 8, size / 8), cdelt=[-SCALE * 4, SCALE * 4])
    obs = np.nan_to_num(jprep.reproject_bilinear(sky, w_h, w_o, (size // 4, size // 4)))
    orig = root / name / "1_originarie"
    jprep.write_fits(orig / "img_lights" / "hst.fits", sky, w_h.to_header())
    jprep.write_fits(orig / "local_raw" / "obs.fits", obs, w_o.to_header())
    return root / name


def test_cli_prep_steps_134_fused_matches_jax(tmp_path):
    """`prep --steps 1,3,4 --fused --device cpu`: registration of solved
    frames, then the fused steps 3+4 at the CLI's stride; the same pairs as
    the JAX `sr prep` on a copy of the target."""
    from superresolution_def_tpu.cli import main as jcli

    t = _solved_target(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    cli_main(["prep", "--data-root", str(tmp_path / "port"), "--steps", "1,3,4", "--fused",
              "--desired-count", "100000", "--device", "cpu"])
    jcli.main(["prep", "--data-root", str(tmp_path / "jax"), "--steps", "1,3,4", "--fused",
               "--desired-count", "100000"])
    j = tmp_path / "jax" / "SYN"
    for d in ("3_registered_native/hubble", "3_registered_native/observatory"):
        for f in (j / d).glob("*.fits"):
            _assert_fits_equal(f, t / d / f.name, atol=1e-6)
    n = len(list((t / "7_dataset_ready_LOG").glob("pair_*")))
    assert n > 0 and len(list((t / "6_patches_final").glob("pair_*"))) == n
    _compare_outputs(j / "6_patches_final", t / "6_patches_final", j / "7_dataset_ready_LOG",
                     t / "7_dataset_ready_LOG", n)
    assert list((tmp_path / "port" / "logs").glob("prep_*.log"))
