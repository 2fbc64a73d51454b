"""Rematerialization in the port (``train --remat``, ``--remat-loss``) and
``train --attn-impl``, against the plain path and the JAX package.

- ``remat_loss``: one step of micro 2 x accum 2 with it on against it off,
  from one seed, augmentation on (and the hybrid's drop-path, warmup off):
  the metrics, G, D with its spectral (u, v), the EMA copy and the
  augmentation and drop-path generators' states agree to 1e-12 (the JAX
  package's ``tests/test_train_steps.py`` bound; here they are the same
  bits: the same autograd graph, its stash recomputed). Then the port's
  ``remat_loss`` step against the JAX ``remat_loss=True`` step on weights
  bridged from the port's, augmentation off, the hybrid's drop-path masks
  injected on both sides: the tolerances of
  ``tests/test_torch_train_step.py`` (losses 1e-5 relative, (u, v) 1e-5,
  weights 2.1e-4 and all but 2% of each tensor's entries 1e-6).
- The spectral-norm trap: a D forward under ``remat`` with another D
  forward between it and its backward gives the plain path's gradients
  bit for bit (the recompute divides by the first forward's sigma), each
  forward advances (u, v) by one power iteration, and the regions keep a
  small share of the plain path's saved bytes.
- ``SwinIR(remat=True)`` and ``HybridHATRealESRGAN(remat=True)``: outputs
  and parameter gradients bit for bit those of ``remat=False``, the
  hybrid with drop-path on, through the module and through the fused
  trunk (``make_fused_hybrid_train``, its plain versions here), the drop
  generator's state after the backward that of the plain path; and
  against the JAX ``remat=True`` modules (the hybrid's drop-path masks
  injected; ``tests/test_remat.py``'s tolerances, outputs 1e-5 and
  gradients 1e-4 relative plus 1e-5, the 1e-5 scaled by the tensor's
  largest entry where that exceeds 1: the loss sums 12,288 squared outputs,
  so its gradients reach tens and fp32 reorders move them by 1e-5).
- The hybrid's data-parallel step on 2 gloo ranks with ``remat_loss`` and
  ``remat`` against the plain step in one process on the whole batch.
- The hybrid's D phase alone (``chip_smoke.py`` [d-learns]'s run, at 64²)
  against the JAX D phase for 10 steps: step for step, and near ln 2.
- ``sr train --device cpu --remat --remat-loss --attn-impl xla``, one tiny
  epoch of each arch, writes the checkpoint bits of the run without the
  flags; ``--attn-impl pallas`` raises at the first G step (K11 is
  forward-only, as the JAX gradient through its Pallas kernels fails).

The JAX states are built from the port's weights (``torch_port``), not by
flax ``init``, which costs ~30 s a state here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.models import HybridHATRealESRGAN as JaxHybrid
from superresolution_def_tpu.models import SwinIR as JaxSwinIR
from superresolution_def_tpu.models import UNetDiscriminatorSNHAT as JaxDHAT
from superresolution_def_tpu.models import UNetDiscriminatorSNSwin as JaxDSwin
from superresolution_def_tpu.models import torch_port
from superresolution_def_tpu.train import make_hat_train_step as jax_hat_step
from superresolution_def_tpu.train import make_swin_train_step as jax_swin_step
from superresolution_def_tpu.train.losses import CombinedGANLoss as JaxCombined
from superresolution_def_tpu.train.state import GANBundle, GANTrainState, _adamw
from superresolution_def_tpu.train.vgg import VGG19Features as JaxVGG
from superresolution_def_tpu_torch.cli.main import main
from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
from superresolution_def_tpu_torch.kernels import make_fused_hybrid_train
from superresolution_def_tpu_torch.models import (
    HybridHATRealESRGAN,
    SwinIR,
    UNetDiscriminatorSNHAT,
    UNetDiscriminatorSNSwin,
    discriminator_hat_state_dict_from_jax,
    discriminator_swin_state_dict_from_jax,
    hybrid_state_dict_from_jax,
    swinir_state_dict_from_jax,
)
from superresolution_def_tpu_torch.models.spectral_norm import SNConv2d, _l2norm
from superresolution_def_tpu_torch.train import (
    CombinedGANLoss,
    VGG19Features,
    create_hat_train_state,
    create_swin_train_state,
    make_hat_train_step,
    make_swin_train_step,
    vgg19_from_torch,
)
from test_torch_hat_train import _flax_masks, _masks, _torch_masks
from test_torch_train_step import _assert_weights

torch.set_num_threads(1)

SWIN = dict(img_size=16, upscale=4, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
            mlp_ratio=2.0)
HAT = dict(img_size=16, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8, num_rrdb=1,
           num_feat=16, num_grow_ch=8)
ACCUM, MICRO = 2, 2
PERCEPTUAL = {"swin": 0.5, "hat": 1.0}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"lr": rng.integers(0, 65535, (ACCUM, MICRO, 16, 16, 1), dtype=np.uint16),
            "hr": rng.integers(0, 65535, (ACCUM, MICRO, 64, 64, 1), dtype=np.uint16)}


def _vgg():
    return VGG19Features(35, generator=torch.Generator().manual_seed(0)).requires_grad_(False)


def _state(arch, **kw):
    if arch == "swin":
        return create_swin_train_state(torch.Generator().manual_seed(0), **SWIN, device="cpu",
                                       **kw)
    return create_hat_train_state(torch.Generator().manual_seed(0), **HAT, device="cpu", **kw)


def _step(arch, state, vgg, **kw):
    crit = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=PERCEPTUAL[arch],
                           adversarial_weight=0.005, vgg_apply=vgg)
    make = make_swin_train_step if arch == "swin" else make_hat_train_step
    return make(state, accum_steps=ACCUM, criterion_g=crit, **kw)


def _bits(state) -> dict:
    return {f"{part}.{k}": v.clone() for part in ("g", "d", "ema")
            for k, v in getattr(state, part).state_dict().items()}


@pytest.mark.parametrize("arch", ["swin", "hat"])
def test_remat_loss_is_the_plain_step(arch):
    vgg, batch, runs = _vgg(), _batch(1), []
    for remat_loss in (False, True):
        state = _state(arch)
        gens = {"augment": torch.Generator().manual_seed(1)}
        kw = {"generator": gens["augment"], "remat_loss": remat_loss}
        if arch == "hat":
            gens["drop"] = kw["drop_generator"] = torch.Generator().manual_seed(2)
        step = _step(arch, state, vgg, **kw)
        metrics = step(batch, 1e-4, 1e-4, *(() if arch == "swin" else (False,)))
        runs.append(({k: float(v) for k, v in metrics.items()}, _bits(state),
                     {k: g.get_state() for k, g in gens.items()}))
    (m0, b0, g0), (m1, b1, g1) = runs
    assert m0.keys() == m1.keys()
    for k in m0:
        assert abs(m0[k] - m1[k]) <= 1e-12, (k, m0[k], m1[k])
    assert b0.keys() == b1.keys()
    worst = max(float((b0[k].double() - b1[k].double()).abs().max()) for k in b0)
    assert worst <= 1e-12, worst
    assert any(k.endswith("weight_u") for k in b0)
    for k, v in g0.items():
        assert torch.equal(v, g1[k]), k


def _jax_start(arch, port, vgg):
    """A JAX state, bundle and perceptual criterion on the port's weights."""
    g_sd = {k: v.numpy() for k, v in port.g.state_dict().items()}
    d_sd = {k: v.numpy() for k, v in port.d.state_dict().items()}
    if arch == "swin":
        g_params = torch_port.swinir_from_torch(g_sd, SWIN["depths"])
        d_params, spectral = torch_port.discriminator_swin_from_torch(d_sd)
        g_mod = JaxSwinIR(in_chans=1, **SWIN)
        d_mod, wd = JaxDSwin(num_in_ch=1, num_feat=64), 0.0
    else:
        g_params = torch_port.hybrid_from_torch(g_sd, HAT)
        d_params, spectral = torch_port.discriminator_hat_from_torch(d_sd)
        g_mod = JaxHybrid(in_chans=1, **HAT)
        d_mod, wd = JaxDHAT(num_in_ch=1, num_feat=64), 0.01
    g_params, d_params, spectral = jax.tree_util.tree_map(jnp.asarray,
                                                          (g_params, d_params, spectral))
    g_tx, d_tx = _adamw(1e-4, wd), _adamw(1e-4, wd)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                          g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params),
                          ema=g_params, spectral=spectral, rng=jax.random.PRNGKey(0))
    bundle = GANBundle(g_apply=g_mod.apply, d_apply=d_mod.apply, g_tx=g_tx, d_tx=d_tx)
    vgg_params = jax.tree_util.tree_map(jnp.asarray, vgg19_from_torch(vgg.state_dict()))
    vgg_mod = JaxVGG(cutoff=35)
    crit = JaxCombined(pixel_weight=1.0, perceptual_weight=PERCEPTUAL[arch],
                       adversarial_weight=0.005,
                       vgg_apply=lambda x: vgg_mod.apply({"params": vgg_params}, x))
    return state, bundle, crit


@pytest.mark.parametrize("arch", ["swin", "hat"])
def test_remat_loss_step_matches_jax(arch):
    port, vgg, batch = _state(arch), _vgg(), _batch(2)
    state, bundle, crit = _jax_start(arch, port, vgg)
    masks = _masks(5, sum(HAT["depths"]), MICRO)
    if arch == "swin":
        new, m = jax_swin_step(bundle, accum_steps=ACCUM, augment=False, criterion_g=crit,
                               remat_loss=True, donate=False)(state, batch, 1e-4, 1e-4)
        tm = _step(arch, port, vgg, augment=False, remat_loss=True)(batch, 1e-4, 1e-4)
        to_g, to_d, noise = swinir_state_dict_from_jax, discriminator_swin_state_dict_from_jax, ()
    else:
        with _flax_masks(masks, HAT["depths"]):
            new, m = jax_hat_step(bundle, accum_steps=ACCUM, augment=False, criterion_g=crit,
                                  remat_loss=True, donate=False)(state, batch, 1e-4, 1e-4,
                                                                 warmup=False)
        with _torch_masks(masks):
            tm = _step(arch, port, vgg, augment=False, remat_loss=True)(batch, 1e-4, 1e-4,
                                                                        False)
        to_g, to_d = hybrid_state_dict_from_jax, discriminator_hat_state_dict_from_jax
        # RaGAN sees only differences of D's logits: conv9's bias has no
        # gradient but rounding noise (tests/test_torch_hat_train.py)
        noise = ("conv9.bias",)
    for k in m:
        np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want_d = to_d(_np_tree(new.d_params), _np_tree(new.spectral))
    got_d = port.d.state_dict()
    for k in want_d:
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(got_d[k].numpy(), want_d[k].numpy(), atol=1e-5,
                                       err_msg=k)
    _assert_weights({k: v for k, v in got_d.items() if k not in noise},
                    {k: v for k, v in want_d.items() if k not in noise}, "D")
    for k in noise:
        assert float((got_d[k] - want_d[k]).abs().max()) <= 2.1e-4, k
    _assert_weights(port.g.state_dict(), to_g(_np_tree(new.g_params)), "G")
    _assert_weights(port.ema.state_dict(), to_g(_np_tree(new.ema)), "EMA")


def _saved_bytes(fn) -> int:
    """Bytes that autograd saves for the backward outside any region of ``fn()``."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("arch", ["swin", "hat"])
def test_spectral_norm_remat_trap(arch):
    """D(x), then D(y), then the backward of D(x) alone: under ``remat`` the
    recompute runs after D(y) has advanced every (u, v); it must divide by
    D(x)'s sigma all the same, and the power iteration must not run again."""
    cls = UNetDiscriminatorSNSwin if arch == "swin" else UNetDiscriminatorSNHAT
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    y = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(2))
    runs = {}
    for remat in (False, True):
        d = cls(num_feat=8, generator=torch.Generator().manual_seed(0))
        start = {n: (m.weight_u, m.weight_v) for n, m in d.named_modules()
                 if isinstance(m, SNConv2d)}
        out = d(x, True, remat)
        d(y, True, remat)
        out.square().sum().backward()
        runs[remat] = ([p.grad for p in d.parameters()], d.state_dict(), start)
        saved = _saved_bytes(lambda: d(x, True, remat))
        runs[remat] += (saved,)
    (g0, s0, start, saved0), (g1, s1, _, saved1) = runs[False], runs[True]
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    d = cls(num_feat=8, generator=torch.Generator().manual_seed(0))
    for name, (u, v) in start.items():
        w2d = d.get_submodule(name).weight_mat().detach()
        for _ in range(2):  # D(x) and D(y): one iteration each
            v = _l2norm(w2d.T @ u)
            u = _l2norm(w2d @ v)
        assert torch.equal(s1[f"{name}.weight_u"], u) and torch.equal(s1[f"{name}.weight_v"], v)
        assert torch.equal(s0[f"{name}.weight_u"], u), name
    # the regions keep their inputs, not their interiors
    assert saved1 < saved0 / 4, (saved1, saved0)


def _bridge(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_remat_reference(swin, sd, x, masks):
    """Output and parameter gradients of sum(out^2) through the JAX
    ``remat=True`` module on the port's weights (the hybrid with drop-path
    on, its masks injected), one jitted call; the gradients as a port
    state dict."""
    xj = jnp.asarray(x.numpy())
    if swin:
        params = _bridge(torch_port.swinir_from_torch(sd, SWIN["depths"]))
        jmod, args, to_torch = JaxSwinIR(in_chans=1, **SWIN, remat=True), (), \
            swinir_state_dict_from_jax
    else:
        params = _bridge(torch_port.hybrid_from_torch(sd, HAT))
        jmod, args, to_torch = JaxHybrid(in_chans=1, **HAT, remat=True), (False,), \
            hybrid_state_dict_from_jax

    def loss(p):
        out = jmod.apply({"params": p}, xj, *args)
        return jnp.sum(out ** 2), out

    with _flax_masks(masks, HAT["depths"]):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), to_torch(_np_tree(grads))


@pytest.mark.parametrize("arch", ["swin", "hybrid"])
def test_generator_remat_matches_plain_and_jax(arch):
    """Outputs and gradients of ``remat=True`` against ``remat=False`` (bits)
    and against the JAX ``remat=True`` module; the hybrid through its module
    and through the fused trunk, with drop-path on: drawn from a generator
    against the plain path, injected masks against JAX."""
    x = torch.rand(2, 16, 24, 1, generator=torch.Generator().manual_seed(1))
    swin = arch == "swin"
    masks = _masks(3, sum(HAT["depths"]), 2)
    want_out = want_grads = None
    for path in ("module",) if swin else ("module", "fused"):
        def build(remat):
            cls = SwinIR if swin else HybridHATRealESRGAN
            model = cls(in_chans=1, **(SWIN if swin else HAT), remat=remat,
                        generator=torch.Generator().manual_seed(0))
            fwd = make_fused_hybrid_train(model, dtype=torch.float32) if path == "fused" \
                else model
            return model, (lambda t, gen=None: fwd(t) if swin else fwd(t, False, gen))

        runs = []
        for remat in (False, True):
            model, fwd = build(remat)
            gen = torch.Generator().manual_seed(7)
            out = fwd(x, gen)
            out.square().sum().backward()
            runs.append((out.detach(), {k: p.grad for k, p in model.named_parameters()},
                         gen.get_state()))
        (o0, g0, r0), (o1, g1, r1) = runs
        assert torch.equal(o0, o1), path
        assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0), path
        # the recompute drew the forward's masks and left the stream where it was
        assert torch.equal(r0, r1), path
        if not swin:
            assert not torch.equal(r0, torch.Generator().manual_seed(7).get_state())

        model, fwd = build(True)
        if want_out is None:
            sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
            want_out, want_grads = _jax_remat_reference(swin, sd, x, masks)
        with _torch_masks(masks):
            out = fwd(x)
        out.square().sum().backward()  # outside the injected masks: the recompute keeps them
        np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, err_msg=path)
        for k, p in model.named_parameters():
            want = want_grads[k].numpy()
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"{path} {k}")


def test_dp_step_with_remat_matches_one_process(tmp_path):
    """The hybrid GAN step on 2 gloo ranks with ``remat_loss`` and ``remat``
    (RaGAN's and the metrics' collectives outside every region, the
    drop-path draws replayed) against the plain step in one process on the
    whole batch, with ``tests/test_torch_parallel.py``'s tolerances."""
    from _torch_dist_worker import run_world
    from test_torch_parallel import _assert_hat_weights, _assert_same_on_every_rank

    state = _state("hat")
    start = {"config": HAT, "g": {k: v.clone() for k, v in state.g.state_dict().items()},
             "ema": {k: v.clone() for k, v in state.ema.state_dict().items()},
             "d": {k: v.clone() for k, v in state.d.state_dict().items()}}
    batch = _batch(3)
    want = make_hat_train_step(state, accum_steps=ACCUM,
                               generator=torch.Generator().manual_seed(1),
                               drop_generator=torch.Generator().manual_seed(2))(
        batch, 1e-4, 1e-4, warmup=False)
    outs = run_world("hat_step", 2, tmp_path, {**start, "batch": batch, "warmup": False,
                                               "remat_loss": True, "remat": True})
    _assert_same_on_every_rank(outs)
    for k, v in want.items():
        np.testing.assert_allclose(outs[0]["metrics"][k], float(v), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    for part, module in (("g", state.g), ("d", state.d), ("ema", state.ema)):
        _assert_hat_weights(outs[0][part], module.state_dict(), part,
                            noise_only=("conv9.bias",))


def test_hybrid_d_alone_follows_jax():
    """``chip_smoke.py`` [d-learns] on the CPU: the hybrid step's own D phase
    (``hat_d_phase``), alone, for 10 AdamW steps (lr 1e-4, weight decay
    0.01) on 2 fixed synthetic pairs at 64² (real: ``synth_batch_u16``'s HR;
    fake: its LR nearest-upsampled), fp32, against the JAX step's D phase
    (``_d_apply_pair``, RaGAN, the JAX AdamW) from the bridged D: the losses
    agree step for step within 1e-5, and both sit within 0.01 of ln 2 at
    the end. The D that does not leave ln 2 on the card does the reference's
    arithmetic."""
    from superresolution_def_tpu.train.losses import DiscriminatorLoss as JaxDLoss
    from superresolution_def_tpu.train.steps import _d_apply_pair
    from superresolution_def_tpu_torch.data import synth_batch_u16
    from superresolution_def_tpu_torch.ops import resize_nearest
    from superresolution_def_tpu_torch.train import DiscriminatorLoss
    from superresolution_def_tpu_torch.train.steps import hat_d_phase, to01

    pairs = synth_batch_u16(2, 64, seed=0)
    real = to01(pairs["hr"], "cpu")
    fake = resize_nearest(to01(pairs["lr"], "cpu"), 4)
    d = UNetDiscriminatorSNHAT(num_feat=64, generator=torch.Generator().manual_seed(0))
    params, spectral = _bridge(torch_port.discriminator_hat_from_torch(
        {k: v.numpy() for k, v in d.state_dict().items()}))
    d_mod, tx, crit = JaxDHAT(num_in_ch=1, num_feat=64), _adamw(1e-4, 0.01), JaxDLoss()
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, spectral, opt_state, fake, real):
        def loss_fn(p, spec):
            d_fake, d_real, spec = _d_apply_pair(d_mod.apply, p, spec, fake, real)
            return crit(d_real, d_fake)[0], spec

        (loss, spectral), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, spectral)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(jnp.add, params, updates), spectral, opt_state, loss

    opt = torch.optim.AdamW(d.parameters(), lr=1e-4, betas=(0.9, 0.99), eps=1e-8,
                            weight_decay=0.01)
    fake_j, real_j = jnp.asarray(fake.numpy()), jnp.asarray(real.numpy())
    got, want = [], []
    for _ in range(11):
        opt.zero_grad()
        got.append(float(hat_d_phase(d, DiscriminatorLoss(), fake, real).detach()))
        opt.step()
        params, spectral, opt_state, loss = jax_step(params, spectral, opt_state, fake_j,
                                                     real_j)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[-1] - np.log(2)) < 0.01 and abs(want[-1] - np.log(2)) < 0.01, (got, want)


def _split(root, name, count, rng):
    entries = []
    for i in range(count):
        hr = rng.random((64, 64))
        d = root / "T1" / "pairs" / f"{name}{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
        entries.append(ManifestEntry(f"{name}{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    write_manifest(root / "T1" / "8_dataset_split" / "splits_json" / f"{name}.json", entries)


def _train_args(arch, data, out):
    args = ["train", "--arch", arch, "--target", "T1", "--device", "cpu", "--data-root",
            str(data), "--outputs-root", str(out), "--epochs", "1", "--batch-size", "2",
            "--img-size", "16"]
    if arch == "swin":
        return args + ["--embed-dim", "16", "--depths", "2", "--num-heads", "2"]
    return args + ["--embed-dim", "30", "--depths", "2", "--num-heads", "6", "--num-rrdb", "1",
                   "--num-feat", "16", "--num-grow-ch", "8", "--accum-steps", "1",
                   "--warmup-epochs", "0", "--ckpt-interval", "1"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    data = tmp_path_factory.mktemp("remat") / "data"
    rng = np.random.default_rng(0)
    for name, count in (("train", 2), ("val", 1), ("test", 1)):
        _split(data, name, count, rng)
    return data


@pytest.mark.parametrize("arch", ["swin", "hat"])
def test_train_cli_remat_flags(split, tmp_path, arch):
    """One epoch with ``--remat --remat-loss --attn-impl xla`` against one
    without: the same checkpoint, to the bit."""
    states = []
    for flags in ([], ["--remat", "--remat-loss", "--attn-impl", "xla"]):
        out = tmp_path / ("flags" if flags else "plain")
        last = main(_train_args(arch, split, out) + flags)
        assert last["epoch"] == 1
        ck = (out / "T1_DDP_SwinIR" / "checkpoints" / "latest_checkpoint.pth" if arch == "swin"
              else out / "T1" / "checkpoints" / "hybrid_epoch_1.pth")
        states.append(torch.load(ck, weights_only=False))
    for part in ("net_g", "net_d", "ema"):
        for k, v in states[0][part].items():
            assert torch.equal(v, states[1][part][k]), (part, k)


@pytest.mark.parametrize("arch", ["swin", "hat"])
def test_train_cli_attn_impl_pallas_raises(split, tmp_path, arch):
    """The module path through K11 fails at the first G step, as the JAX
    gradient through its Pallas attention does."""
    with pytest.raises(RuntimeError, match="forward-only"):
        main(_train_args(arch, split, tmp_path) + ["--attn-impl", "pallas"])
