"""The port's train steps learn: the property of the JAX ``tests/test_learns.py``.

N real optimizer steps of ``make_swin_train_step`` and
``make_hat_train_step`` at the JAX test's tiny configurations, on the
structured synthetic skies of ``data/synth.py`` (the generator of the
committed TPU proofs and of the card's, ``tools/train_learns.py``), must
lift raw-G (not EMA: it lags far behind at these step counts) PSNR over the
random init's by the JAX test's margin of 5 dB. A sign-flipped gradient, a
dead optimizer or a mis-wired update cannot. The hybrid runs half its steps
in the L1 warmup and half in the GAN phase, the transition its trainer makes.
"""

import numpy as np
import torch

from superresolution_def_tpu_torch.data import synth_batch_u16
from superresolution_def_tpu_torch.train import (
    cosine_annealing_lr,
    create_hat_train_state,
    create_swin_train_state,
    make_eval_step,
    make_hat_train_step,
    make_swin_train_step,
)

torch.set_num_threads(1)

LR_SIZE = 16
HR_SIZE = 64
N_STEPS = 32
MARGIN_DB = 5.0


def _batches(accum: int, b: int, n_steps: int, seed: int = 0):
    """n_steps step-batches of shape (accum, b, H, W, 1) from one pool."""
    pool = synth_batch_u16(accum * b * n_steps, HR_SIZE, seed=seed)
    lr = pool["lr"].reshape(n_steps, accum, b, LR_SIZE, LR_SIZE, 1)
    hr = pool["hr"].reshape(n_steps, accum, b, HR_SIZE, HR_SIZE, 1)
    return [{"lr": lr[i], "hr": hr[i]} for i in range(n_steps)]


def _raw_g_psnr(forward, eval_batch) -> float:
    out = make_eval_step(forward)(eval_batch, "cpu")
    return out["psnr_sum"] / out["count"]


def test_swin_step_learns():
    state = create_swin_train_state(torch.Generator().manual_seed(0), img_size=LR_SIZE,
                                    upscale=4, embed_dim=32, depths=(2, 2), num_heads=(4, 4),
                                    window_size=8, device="cpu")
    step = make_swin_train_step(state, accum_steps=2)
    eval_batch = synth_batch_u16(4, HR_SIZE, seed=999)

    psnr0 = _raw_g_psnr(state.g_forward, eval_batch)
    lr = cosine_annealing_lr(1)
    for batch in _batches(2, 2, N_STEPS):
        metrics = step(batch, lr, lr)
    assert np.isfinite(float(metrics["loss_g"]))

    psnr1 = _raw_g_psnr(state.g_forward, eval_batch)
    assert psnr1 - psnr0 > MARGIN_DB, (
        f"swin raw-G PSNR gain {psnr1 - psnr0:.2f} dB after {N_STEPS} steps "
        f"(init {psnr0:.2f} -> {psnr1:.2f}); expected > {MARGIN_DB}")


def test_hat_step_learns_through_warmup_transition():
    state = create_hat_train_state(torch.Generator().manual_seed(0), img_size=LR_SIZE,
                                   embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                                   num_rrdb=2, num_feat=16, num_grow_ch=8, device="cpu")
    step = make_hat_train_step(state, accum_steps=2)
    eval_batch = synth_batch_u16(4, HR_SIZE, seed=998)

    psnr0 = _raw_g_psnr(state.g_forward, eval_batch)
    lr = cosine_annealing_lr(1)
    batches = _batches(2, 1, N_STEPS, seed=1)
    for batch in batches[: N_STEPS // 2]:
        metrics = step(batch, lr, lr, warmup=True)
    assert float(metrics["loss_d"]) == 0.0  # no D phase in the warmup
    for batch in batches[N_STEPS // 2:]:
        metrics = step(batch, lr, lr, warmup=False)
    assert np.isfinite(float(metrics["loss_g"]))
    assert float(metrics["loss_d"]) > 0.0  # D trained in the GAN phase

    psnr1 = _raw_g_psnr(state.g_forward, eval_batch)
    assert psnr1 - psnr0 > MARGIN_DB, (
        f"hat raw-G PSNR gain {psnr1 - psnr0:.2f} dB after {N_STEPS} steps "
        f"(init {psnr0:.2f} -> {psnr1:.2f}); expected > {MARGIN_DB}")
