"""K13's plain version (the stage-ablation block) against the JAX script's kernel.

``scripts/swin_stage_ablation.py`` is loaded as a module and its width
constants are set on the loaded module to a small block (C=16, 2 heads of
8, hidden 32, 8 windows in tiles of 4) before its jitted ``block`` is first
traced; the script's file is not changed. Its Pallas kernel runs in
interpret mode on the CPU, jitted and waited for before anything else is
dispatched, for each of the nine modes; the port's
``swin_stage_block`` takes the same numpy-seeded operands and runs its plain
version there (the kernel's CPU path).

Tolerances: each output within 1e-5 (fp32) or 1e-2 (bf16) of its largest
entry: the same math with sums in other orders (and in bf16 the same
rounding points, so an intermediate on the other side of a rounding step
moves what follows). The erf polynomial's 26 coefficients are the script's,
bit for bit, and ``erf_coef`` takes others in their place (zeros, held
against the script with its ``_ERF_COEF`` zeroed on the loaded module).
The ``packed`` keyword (K1's packed weights, which the kernel reads) leaves
the CPU result the plain version's, and a packing of the wrong size or
type raises there as on the card.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu_torch.kernels import pack_swin_block_weights, swin_stage_block
from superresolution_def_tpu_torch.kernels.swin_stage_ablation import (
    MODES,
    erf_coefficients,
    packed_elems,
    swin_stage_block_reference,
)

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "swin_stage_ablation.py"
C, HEADS, HIDDEN, BW, BLK, D = 16, 2, 32, 8, 4, 8
SCALE = D**-0.5
NAMES = ["ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj", "bproj", "ln2_w", "ln2_b", "w1",
         "b1", "w2", "b2"]
IO = {"wqkv", "wproj", "w1", "w2"}  # in the io dtype; vectors and the bias table fp32
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _load_script(**constants):
    spec = importlib.util.spec_from_file_location("swin_stage_ablation_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in dict(C=C, HEADS=HEADS, HIDDEN=HIDDEN, BW=BW, BLK=BLK, D=D,
                            SCALE=SCALE, **constants).items():
        setattr(mod, name, value)
    return mod


@functools.cache
def script():
    return _load_script()


def _inputs(seed):
    r = np.random.default_rng(seed)

    def f(*s, base=0.0, std=0.3):
        return (base + std * r.standard_normal(s)).astype(np.float32)

    x = f(BW, 64, C, std=1.0)
    return x, dict(
        ln1_w=f(C, base=1.0, std=0.1), ln1_b=f(C, std=0.1), wqkv=f(C, 3 * C),
        bqkv=f(3 * C, std=0.1), bias=f(HEADS, 64, 64, std=0.5), wproj=f(C, C),
        bproj=f(C, std=0.1), ln2_w=f(C, base=1.0, std=0.1), ln2_b=f(C, std=0.1),
        w1=f(C, HIDDEN), b1=f(HIDDEN, std=0.1), w2=f(HIDDEN, C), b2=f(C, std=0.1),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_stage_block_matches_the_script(mode, dtype):
    jdt, tdt = DTYPES[dtype]
    x, p = _inputs(MODES.index(mode))
    weights = tuple(jnp.asarray(p[k], jdt if k in IO else jnp.float32) for k in NAMES)
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(script().block(jnp.asarray(x, jdt), weights, mode))
    targs = [torch.from_numpy(p[k]).to(tdt) if k in IO else torch.from_numpy(p[k])
             for k in NAMES]
    got = swin_stage_block(torch.from_numpy(x).to(tdt), *targs, mode=mode, num_heads=HEADS,
                           scale=SCALE)
    assert got.dtype == tdt and got.shape == (BW, 64, C)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = (1e-5 if dtype == "float32" else 1e-2) * np.abs(want).max()
    assert err <= tol, (mode, dtype, err, np.abs(want).max())


def test_erf_coefficients_are_the_scripts():
    want = np.asarray(script()._ERF_COEF)
    got = erf_coefficients()
    assert got.dtype == np.float32 and got.shape == (26,)
    assert np.array_equal(got, want)


def test_polygelu_evaluates_the_given_coefficients():
    """``erf_coef`` replaces the fit: zeros (erf read as 0, so u / 2) meet
    the script's block with its ``_ERF_COEF`` zeroed, fp32 at 1e-5 of the
    largest entry, and move the output far from the fitted polynomial's."""
    zeros = np.zeros(26, np.float32)
    x, p = _inputs(9)
    weights = tuple(jnp.asarray(p[k]) for k in NAMES)
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(
            _load_script(_ERF_COEF=zeros).block(jnp.asarray(x), weights, "mlp_polygelu"))
    targs = [torch.from_numpy(p[k]) for k in NAMES]
    kw = dict(mode="mlp_polygelu", num_heads=HEADS, scale=SCALE)
    got = swin_stage_block(torch.from_numpy(x), *targs, erf_coef=zeros, **kw).numpy()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    fitted = swin_stage_block(torch.from_numpy(x), *targs, **kw).numpy()
    assert np.abs(fitted - got).max() > 1e-2 * np.abs(want).max()
    with pytest.raises(ValueError, match="26 coefficients"):
        swin_stage_block(torch.from_numpy(x), *targs, erf_coef=zeros[:25], **kw)


def test_allheads_is_full_and_unknown_modes_raise():
    x, p = _inputs(0)
    targs = [torch.from_numpy(p[k]).to(torch.bfloat16) if k in IO else torch.from_numpy(p[k])
             for k in NAMES]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kw = dict(num_heads=HEADS, scale=SCALE)
    assert torch.equal(swin_stage_block(xt, *targs, mode="full", **kw),
                       swin_stage_block(xt, *targs, mode="allheads", **kw))
    with pytest.raises(ValueError, match="mode is one of"):
        swin_stage_block(xt, *targs, mode="packed", **kw)


def test_ablation_tool_runs_on_the_cpu(capsys, monkeypatch):
    from superresolution_def_tpu_torch.tools import swin_stage_ablation as tool

    monkeypatch.setattr(tool, "WINDOWS", 2)  # the script's way: its sizes are constants
    monkeypatch.setattr(tool, "BLOCKS", 2)
    times = tool.main(["full", "allheads", "mlp_siggelu", "--device", "cpu"])
    assert list(times) == ["full", "allheads", "mlp_siggelu"]
    assert all(np.isfinite(t) and t > 0 for t in times.values())
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "allheads vs full max|err|: 0.00e+00"
    assert out[1].startswith("device: cpu")
    assert len(out) == 5 and out[2].split(":")[0].strip() == "full"


def _bf16_args(seed):
    x, p = _inputs(seed)
    targs = [torch.from_numpy(p[k]).to(torch.bfloat16) if k in IO else torch.from_numpy(p[k])
             for k in NAMES]
    return torch.from_numpy(x).to(torch.bfloat16), targs


@pytest.mark.parametrize("mode", ["full", "noattn", "mlponly", "mlp_tanhgelu"])
def test_packed_weights_on_cpu_give_the_plain_version(mode):
    xt, targs = _bf16_args(3)
    kw = dict(mode=mode, num_heads=HEADS, scale=SCALE)
    packed = pack_swin_block_weights(targs[2], targs[5], targs[9], targs[11], num_heads=HEADS)
    assert packed.shape == (packed_elems(C, HEADS, HIDDEN),)
    before = swin_stage_block.launches
    got = swin_stage_block(xt, *targs, **kw, packed=packed)
    assert torch.equal(got, swin_stage_block_reference(xt, *targs, **kw))
    assert swin_stage_block.launches == before


def test_wrongly_shaped_packed_weights_raise():
    xt, targs = _bf16_args(4)
    kw = dict(mode="full", num_heads=HEADS, scale=SCALE)
    packed = pack_swin_block_weights(targs[2], targs[5], targs[9], targs[11], num_heads=HEADS)
    for bad in (packed[:-8], packed.float(), packed.reshape(2, -1)):
        with pytest.raises(ValueError, match="packed wants"):
            swin_stage_block(xt, *targs, **kw, packed=bad)
