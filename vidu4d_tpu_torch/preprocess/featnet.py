"""Learned dense registration descriptors, the DINOv2 slot
(`vidu4d_tpu/preprocess/featnet.py`): a small conv encoder trained in-repo
with a dense InfoNCE objective (`info_nce_pair`), its held-out score
(`match_accuracy`) and its weights file. Layout NCHW; the weights are the
shipped flax ones (`load_featnet`), written back by `save_weights`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidu4d_tpu_torch.convert import flax_conv_net_flat
from vidu4d_tpu_torch.utils.io import savez_atomic
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


def _unit(f: torch.Tensor) -> torch.Tensor:
    return f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-6)


def info_nce_pair(feat1: torch.Tensor, feat2: torch.Tensor, xy1: torch.Tensor,
                  xy2: torch.Tensor, temp: float = 0.07) -> torch.Tensor:
    """Symmetric dense InfoNCE of one image pair (`featnet.py:73`): the
    features (H/2, W/2, D) sampled at xy1 / xy2 (N, 2) full-resolution
    pixels; xy1[i] must match xy2[i] against every other sampled point."""
    f1 = _unit(sample_features(feat1, xy1))
    f2 = _unit(sample_features(feat2, xy2))
    logits = (f1 @ f2.T) / temp
    return 0.5 * (torch.mean(-torch.diagonal(F.log_softmax(logits, dim=1)))
                  + torch.mean(-torch.diagonal(F.log_softmax(logits, dim=0))))


@torch.no_grad()
def match_accuracy(feat1: torch.Tensor, feat2: torch.Tensor, xy1, xy2,
                   radius_px: float = 4.0) -> float:
    """Fraction of the xy1 points whose most similar sampled xy2 point lies
    within ``radius_px`` of its true correspondence (`featnet.py:98`)."""
    dev = feat1.device
    xy1 = torch.as_tensor(np.asarray(xy1), dtype=torch.float32, device=dev)
    xy2 = torch.as_tensor(np.asarray(xy2), dtype=torch.float32, device=dev)
    sim = _unit(sample_features(feat1, xy1)) @ _unit(sample_features(feat2, xy2)).T
    best = torch.argmax(sim, dim=1)
    d = torch.linalg.vector_norm(xy2[best] - xy2, dim=-1)
    return int((d <= radius_px).sum()) / d.numel()


def save_weights(path: str, model: FeatNet) -> None:
    """``model``'s weights as the shipped ``featnet_synthetic.npz`` holds
    them (`featnet.py:111`): flax keys under "params/", ``np.savez``'s
    bytes, written to a temporary file and moved into place (a killed run
    never leaves a truncated npz)."""
    savez_atomic(path, flax_conv_net_flat(model, "params/"))


def load_featnet(path: Optional[str] = None, device="cuda") -> Optional[FeatNet]:
    """FeatNet with the shipped weights (``$VIDU4D_FEATNET_NPZ`` or
    ``vidu4d_tpu/weights/featnet_synthetic.npz``) on ``device``; None when
    the file does not exist."""
    return load_net(FeatNet(), path or weights_path(WEIGHTS_ENV, WEIGHTS_FILE), device)
