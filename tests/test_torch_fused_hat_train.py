"""The fused-HAB training path of the port against the JAX package, on the CPU.

- ``make_fused_hat_train``: outputs and gradients (input and every
  parameter) against the JAX ``make_fused_hat_train`` on weights bridged by
  ``hat_state_dict_from_jax``, fp32, first deterministic, then with
  drop-path on and the port fed the JAX draws through
  ``injected_drop_masks`` (rate 0.5, so that samples are dropped), and with
  the OCABs through the module (``fused_ocab=False``, the JAX ``_ocab``). The JAX
  kernels run in Pallas interpret mode, the port's plain versions stand in
  for its kernels. Bound: rtol 1e-4 and atol 1e-5 of each tensor's largest
  entry for the outputs, 2e-4 and 2e-5 for the gradients (fp32 sums in
  another order, as tests/test_fused_hat_train.py bounds the JAX path
  against flax).
- ``train --arch hat --fused-hab --device cpu`` end to end.

One GAN step of the fused-HAB state against the JAX fused state is
tests/test_torch_fused_hab_step.py; against the flax step with drop-path
masks, tests/test_torch_hat_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels.fused_hat import make_fused_hat_train as jax_fused_hat_train
from superresolution_def_tpu.models.hat import HAT as JaxHAT
from superresolution_def_tpu_torch.kernels import make_fused_hat_train
from superresolution_def_tpu_torch.models import HAT, hat_state_dict_from_jax, injected_drop_masks

torch.set_num_threads(1)

# Every JAX reference below runs as one jitted program and is waited for at
# once: dispatching eager JAX ops while an interpreted Pallas kernel's host
# callbacks (which run jnp ops themselves) are in flight can deadlock the
# CPU client.

CFG = dict(img_size=16, in_chans=1, embed_dim=30, depths=(2, 2), num_heads=(6, 6),
           window_size=8, upscale=2, img_range=1.0)
RATE = 0.5


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_draws(key, batch):
    """The keep-masks the JAX fused HAT draws from ``key``, per (block, call)."""
    dpr = np.linspace(0.0, RATE, sum(CFG["depths"]))
    masks = {}
    for i, rate in enumerate(dpr):
        if rate == 0.0:
            continue
        key, k1, k2 = jax.random.split(key, 3)
        for call, k in enumerate((k1, k2)):
            masks[i, call] = np.asarray(
                jax.random.bernoulli(k, 1.0 - rate, (batch,)), np.float32).reshape(batch, 1, 1)
    return masks


@pytest.fixture(scope="module")
def bridged():
    params = JaxHAT(**CFG, upsampler="pixelshuffle", drop_path_rate=RATE).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"]
    port = HAT(**CFG, drop_path_rate=RATE)
    port.load_state_dict(hat_state_dict_from_jax(_np_tree(params)))
    return params, port


@pytest.mark.parametrize("deterministic,fused_ocab", [(True, True), (False, True),
                                                     (True, False)])
def test_fused_hat_train_matches_jax(bridged, deterministic, fused_ocab):
    params, port = bridged
    rng = np.random.default_rng(1)
    x = rng.random((2, 16, 16, 1)).astype(np.float32)
    probe = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    masks = _jax_draws(key, 2)
    if not deterministic:  # the draws drop some samples and keep others
        values = np.concatenate([m.ravel() for m in masks.values()])
        assert 0.0 < values.mean() < 1.0
    jfn = jax_fused_hat_train(depths=CFG["depths"], num_heads=CFG["num_heads"], window_size=8,
                              drop_path_rate=RATE, dtype=jnp.float32, fused_ocab=fused_ocab)

    def fwd(p, xin):
        return jfn(p, xin, deterministic, key)

    def loss(p, xin):
        return jnp.sum(fwd(p, xin) * probe)

    with pltpu.force_tpu_interpret_mode():
        jout = jax.block_until_ready(jax.jit(fwd)(params, jnp.asarray(x)))
        gp, gx = jax.block_until_ready(jax.jit(jax.grad(loss, argnums=(0, 1)))(
            params, jnp.asarray(x)))

    fused = make_fused_hat_train(port, dtype=torch.float32, fused_ocab=fused_ocab)
    xt = torch.from_numpy(x).requires_grad_()
    port.zero_grad(set_to_none=True)
    with injected_drop_masks(lambda index, call, t: torch.from_numpy(masks[index, call]).to(
            t.device, t.dtype)):
        out = fused(xt, deterministic)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jout)).max())
    (out * torch.from_numpy(probe)).sum().backward()
    want = hat_state_dict_from_jax(_np_tree(gp))
    got = {"input": xt.grad, **{k: p.grad for k, p in port.named_parameters()}}
    want["input"] = torch.from_numpy(np.array(gx))
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"grad of {k}")


def test_train_cli_fused_hab_on_the_cpu(tmp_path, monkeypatch):
    """``--fused-hab`` on ``--device cpu`` trains through the fused
    generator's plain versions (not the module path): every HAB's forward
    goes through K9a's plain version, and the run is written."""
    from superresolution_def_tpu_torch.cli.main import main
    from superresolution_def_tpu_torch.kernels import hab_train
    from test_torch_hat_trainers import _split

    calls = []
    plain = hab_train.hab_fwd_h_reference
    monkeypatch.setattr(hab_train, "hab_fwd_h_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for name, count in (("train", 2), ("test", 1)):
        _split(data, name, count, rng)
    last = main(["train", "--arch", "hat", "--fused-hab", "--target", "T1", "--device", "cpu",
                 "--data-root", str(data), "--outputs-root", str(tmp_path / "outputs"),
                 "--epochs", "1", "--warmup-epochs", "0", "--batch-size", "2",
                 "--accum-steps", "1", "--img-size", "16", "--embed-dim", "30", "--depths", "2",
                 "--num-heads", "6", "--num-rrdb", "1", "--num-feat", "16", "--num-grow-ch", "8",
                 "--ckpt-interval", "1", "--img-interval", "1", "--csv-interval", "1"])
    assert last["epoch"] == 1
    assert all(np.isfinite(last[k]) for k in ("g_total", "l1", "d_total", "psnr", "ssim"))
    run = tmp_path / "outputs" / "T1"
    assert (run / "checkpoints" / "hybrid_epoch_1.pth").exists()
    assert (run / "previews" / "epoch_001_preview.png").exists()
    assert len(calls) == 2 * 2  # 2 HABs in the step's forward and in the preview's
