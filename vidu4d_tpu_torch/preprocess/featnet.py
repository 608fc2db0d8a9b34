"""Learned dense registration descriptors, the DINOv2 slot
(`vidu4d_tpu/preprocess/featnet.py`), inference: a small conv encoder
trained in-repo with a dense InfoNCE objective. Layout NCHW; the weights
are the shipped flax ones (`load_featnet`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vidu4d_tpu_torch.preprocess.layers import SameConv2d, load_net, weights_path

WEIGHTS_ENV, WEIGHTS_FILE = "VIDU4D_FEATNET_NPZ", "featnet_synthetic.npz"


class FeatNet(nn.Module):
    """(B, 3, H, W) in [0, 1] -> (B, dim, H/2, W/2), unit length per pixel
    (`featnet.py:26`)."""

    FLAX_NAMES = {f"Conv_{i}": f"convs.{i}" for i in range(5)}

    def __init__(self, width: int = 48, dim: int = 32, device=None):
        super().__init__()
        w = width
        self.convs = nn.ModuleList([
            SameConv2d(3, w, 5, 2, device=device),
            SameConv2d(w, 2 * w, 3, device=device),
            SameConv2d(2 * w, 2 * w, 3, device=device),
            SameConv2d(2 * w, 2 * w, 3, device=device),
            SameConv2d(2 * w, dim, 1, device=device),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        x = F.relu(c[0](x * 2.0 - 1.0))
        r = F.relu(c[1](x))
        x = F.relu(c[3](F.relu(c[2](r))) + r)  # residual block
        x = c[4](x)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-6)


def sample_features(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (N, D) of half-resolution features (H, W, D) at
    full-resolution pixel coordinates xy (N, 2) (`featnet.py:54`)."""
    h, w = feat.shape[:2]
    x = torch.clamp(xy[:, 0] / 2.0, 0.0, w - 1.001)
    y = torch.clamp(xy[:, 1] / 2.0, 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    return (feat[y0, x0] * (1 - wx) * (1 - wy) + feat[y0, x0 + 1] * wx * (1 - wy)
            + feat[y0 + 1, x0] * (1 - wx) * wy + feat[y0 + 1, x0 + 1] * wx * wy)


def load_featnet(path: Optional[str] = None, device="cuda") -> Optional[FeatNet]:
    """FeatNet with the shipped weights (``$VIDU4D_FEATNET_NPZ`` or
    ``vidu4d_tpu/weights/featnet_synthetic.npz``) on ``device``; None when
    the file does not exist."""
    return load_net(FeatNet(), path or weights_path(WEIGHTS_ENV, WEIGHTS_FILE), device)
