"""superresolution_def_tpu_torch — the PyTorch/CUDA port of superresolution_def_tpu.

The JAX package beside it stays the reference; this package mirrors its
layout and, slice by slice, its behaviour:

- ``ops``      — window geometry, NHWC pixel-shuffle, reflect pad, PSNR/SSIM
- ``models``   — ``SwinIR`` as an ``nn.Module`` with the reference torch keys,
                 checkpoint loading and the JAX -> torch weight bridge
- ``kernels``  — hand-written Hopper kernels (``csrc/*.cu``, built with nvcc
                 on first use) and their plain PyTorch versions
- ``data``     — manifests and the split, 16-bit TIFF IO, the ordered patch iterator
- ``prep``     — FITS/WCS dataset prep: registration, patch pairs, normalization
- ``cli``      — ``prep``, ``split``, ``train``, ``infer``, ``upscale``
                 (``python -m superresolution_def_tpu_torch.cli.main``)

It imports torch and never jax.
"""

__version__ = "0.1.0"
