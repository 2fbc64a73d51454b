"""Convert a torchvision VGG19 checkpoint to the JAX package's VGG npz (the JAX ``cli/port_vgg.py``).

Usage:
  python -m superresolution_def_tpu_torch.cli.port_vgg vgg19.pth vgg19_feat35.npz [cutoff]

The npz holds ``params``, a pickled dict of ``conv_{i}`` HWIO kernels and
biases for ``features[:cutoff+1]`` (cutoff 35: through relu5_4, the
reference's VGGLoss, utils/losses_train_swin.py:6-40): the file that the JAX
package's ``cli/port_vgg.py`` writes, made here without jax. ``train
--vgg-weights`` of either package reads it; the port's also reads the
``.pth`` itself. The user supplies the ``.pth`` (torchvision's ``vgg19``
ImageNet weights); nothing is downloaded.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..train.vgg import vgg19_from_torch


def convert(pth_path: str, out_path: str, cutoff: int = 35) -> None:
    obj = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if hasattr(obj, "get") else obj
    params = vgg19_from_torch(sd, cutoff=cutoff)
    np.savez(out_path, params=np.array(params, dtype=object))
    print(f"wrote {out_path}: {len(params)} conv layers (cutoff {cutoff})")


if __name__ == "__main__":
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    convert(sys.argv[1], sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 35)
