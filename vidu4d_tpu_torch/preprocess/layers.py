"""Building blocks of the Stage-1 nets (RAFT-small, DepthNet, FeatNet) with
flax's semantics, and where their shipped weights are read from.

- `SameConv2d`: flax ``nn.Conv`` padding "SAME" pads asymmetrically when
  the stride does not divide the padding evenly (a 3x3 stride-2 conv on an
  even size pads (0, 1), a 5x5 (1, 2), a 7x7 (2, 3)); ``nn.Conv2d``'s
  symmetric padding gives other outputs, so the pad is computed per call.
- `group_norm`: flax's ``nn.GroupNorm`` has eps 1e-6 (torch's 1e-5).
- `weights_path`: the shipped ``.npz`` files are data of the repo, read
  from ``vidu4d_tpu/weights/`` (found from the repo root) or from the file
  an environment variable names, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(REPO_ROOT, "vidu4d_tpu", "weights")


def same_pads(size: int, kernel: int, stride: int):
    """(lo, hi) zero padding of flax's "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) with flax's "SAME" padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, device=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        pw = same_pads(x.shape[-1], k, s)
        ph = same_pads(x.shape[-2], k, s)
        if any(pw + ph):
            x = F.pad(x, pw + ph)
        return super().forward(x)


def group_norm(channels: int, groups: int = 8, device=None) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-6, device=device)


def weights_path(env: str, filename: str) -> str:
    """``$env`` when it is set, else ``vidu4d_tpu/weights/<filename>``."""
    return os.environ.get(env, "") or os.path.join(WEIGHTS_DIR, filename)


def load_net(module: nn.Module, path: str, device) -> Optional[nn.Module]:
    """``module`` with the flax weights of the .npz at ``path``
    (`convert.load_flax_conv_net_`), in eval mode on ``device``; None when
    the file does not exist. A file that exists but does not load raises."""
    from vidu4d_tpu_torch.convert import load_flax_conv_net_

    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        load_flax_conv_net_(module, {k: data[k] for k in data.files})
    return module.to(device).eval()
