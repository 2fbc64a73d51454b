"""Checkpoint loading, SwinIR shape sniffing, and the JAX -> torch weight bridge.

``unwrap_state_dict``, ``load_torch_state_dict`` and ``detect_swinir_params``
are the JAX package's ``models/torch_port.py`` helpers working on tensors.
:func:`swinir_state_dict_from_jax` is the exact inverse of its
``swinir_from_torch``: it turns the JAX SwinIR params tree (numpy arrays)
into this package's ``state_dict``; :func:`discriminator_swin_state_dict_from_jax`
and :func:`vgg19_state_dict_from_jax` invert ``discriminator_swin_from_torch``
and ``vgg19_from_torch`` the same way.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def unwrap_state_dict(obj: Any) -> dict[str, Any]:
    """Reference key search order net_g -> model_state_dict -> raw, then strip
    ``module.`` prefixes (infer_swin.py:88-89, infer_hat.py:157-166)."""
    if hasattr(obj, "items"):
        for key in ("net_g", "model_state_dict"):
            if key in obj and hasattr(obj[key], "items"):
                obj = obj[key]
                break
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Load a .pth file into a CPU state dict.

    ``weights_only=False``, as the JAX package loads it: reference trainers
    pickle whole training states. Load only checkpoints you trust.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.detach() for k, v in unwrap_state_dict(obj).items() if torch.is_tensor(v)}


def detect_swinir_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """Shape-sniff SwinIR hyperparameters: embed dim, exact per-layer depths
    and head counts, and the mlp_ratio from fc1's width."""
    params: dict[str, Any] = {"embed_dim": 96, "depths": [6, 6, 6, 6], "num_heads": [6, 6, 6, 6]}
    if "conv_first.weight" in sd:
        params["embed_dim"] = int(sd["conv_first.weight"].shape[0])
    layer_depth: dict[int, int] = {}
    for k in sd:
        if k.startswith("layers."):
            parts = k.split(".")
            try:
                li, bj = int(parts[1]), int(parts[2])
            except (ValueError, IndexError):
                continue
            layer_depth[li] = max(layer_depth.get(li, 0), bj + 1)
    if layer_depth:
        n = max(layer_depth) + 1
        params["depths"] = [layer_depth.get(i, 6) for i in range(n)]
        heads = []
        for i in range(n):
            key = f"layers.{i}.0.attn.relative_position_bias_table"
            heads.append(int(sd[key].shape[-1]) if key in sd else 6)
        params["num_heads"] = heads
    fc1 = "layers.0.0.mlp.fc1.weight"
    if fc1 in sd and params["embed_dim"]:
        params["mlp_ratio"] = float(sd[fc1].shape[0]) / params["embed_dim"]
    else:
        params["mlp_ratio"] = 4.0
    return params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out, key, p) -> None:
    out[key + ".weight"] = _t(p["conv"]["kernel"]).permute(3, 2, 0, 1).contiguous()  # HWIO->OIHW
    if "bias" in p["conv"]:
        out[key + ".bias"] = _t(p["conv"]["bias"])


def _dense(out, key, p) -> None:
    out[key + ".weight"] = _t(p["linear"]["kernel"]).T.contiguous()  # (I, O) -> (O, I)
    if "bias" in p["linear"]:
        out[key + ".bias"] = _t(p["linear"]["bias"])


def _ln(out, key, p) -> None:
    out[key + ".weight"] = _t(p["ln"]["scale"])
    out[key + ".bias"] = _t(p["ln"]["bias"])


def swinir_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``models.swinir.SwinIR`` params tree -> this package's ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    _conv(out, "conv_first", params["conv_first"])
    _ln(out, "norm", params["norm"])
    _conv(out, "conv_after_body", params["conv_after_body"])
    _conv(out, "conv_before_upsample.0", params["conv_before_upsample"])
    _conv(out, "conv_last", params["conv_last"])
    s = 0
    while f"upsample_{s}" in params:
        _conv(out, f"upsample.{2 * s}", params[f"upsample_{s}"])
        s += 1
    for name, p in params.items():
        if not name.startswith("layers_"):
            continue
        _, i, j = name.split("_")
        key = f"layers.{i}.{j}"
        _ln(out, key + ".norm1", p["norm1"])
        _ln(out, key + ".norm2", p["norm2"])
        _dense(out, key + ".mlp.fc1", p["mlp"]["fc1"])
        _dense(out, key + ".mlp.fc2", p["mlp"]["fc2"])
        _dense(out, key + ".attn.qkv", p["attn"]["qkv"])
        _dense(out, key + ".attn.proj", p["attn"]["proj"])
        out[key + ".attn.relative_position_bias_table"] = _t(
            p["attn"]["relative_position_bias_table"]
        )
    return out


_SWIN_D_KEYS = [("conv0_0", "conv0.0", False), ("conv0_1", "conv0.2", False)]
_SWIN_D_KEYS += [(f"conv{i}", f"conv{i}.model.0", False) for i in range(1, 5)]
_SWIN_D_KEYS += [(f"up{i}", f"up{i}.model.0", True) for i in range(1, 5)]
_SWIN_D_KEYS += [("final_0", "final_conv.0", False), ("final_1", "final_conv.2", False)]


def discriminator_swin_state_dict_from_jax(params: Mapping[str, Any],
                                           spectral: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``UNetDiscriminatorSNSwin`` params and ``spectral`` (u, v) ->
    this package's ``state_dict``: the inverse of ``discriminator_swin_from_torch``."""
    out: dict[str, torch.Tensor] = {}
    for name, key, transpose in _SWIN_D_KEYS:
        kernel = _t(params[name]["kernel"])  # (kh, kw, I, O)
        # torch Conv2d (O, I, kh, kw); ConvTranspose2d (I, O, kh, kw)
        w = kernel.permute(2, 3, 0, 1) if transpose else kernel.permute(3, 2, 0, 1)
        out[key + ".weight_orig"] = w.contiguous()
        out[key + ".weight_u"] = _t(spectral[name]["u"])
        out[key + ".weight_v"] = _t(spectral[name]["v"])
    return out


def vgg19_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``VGG19Features`` params (``conv_{i}``) -> ``features.{i}.*``: the
    inverse of ``train/vgg.py::vgg19_from_torch``."""
    out: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        i = int(name.split("_")[1])
        out[f"features.{i}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
        out[f"features.{i}.bias"] = _t(p["bias"])
    return out
