"""Learned monocular depth (`vidu4d_tpu/preprocess/depthnet.py`), inference:
the U-Net trained in-repo on synthetic renders (the ZoeDepth slot). Layout
NCHW; the weights are the shipped flax ones (`load_depthnet`).

Output convention (MiDaS): per-pixel disparity up to an affine map;
`disparity_to_depth` maps it into a depth range per image.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vidu4d_tpu_torch.preprocess.layers import SameConv2d, group_norm, load_net, weights_path
from vidu4d_tpu_torch.preprocess.ops import resize

WEIGHTS_ENV, WEIGHTS_FILE = "VIDU4D_DEPTHNET_NPZ", "depthnet_synthetic.npz"


class ConvBlock(nn.Module):
    """conv (stride s) -> GroupNorm -> GELU -> conv -> GroupNorm -> GELU;
    flax's ``nn.gelu`` is the tanh approximation."""

    FLAX_NAMES = {"Conv_0": "conv1", "GroupNorm_0": "norm1", "Conv_1": "conv2",
                  "GroupNorm_1": "norm2"}

    def __init__(self, cin: int, feats: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = SameConv2d(cin, feats, 3, stride, device=device)
        self.norm1 = group_norm(feats, device=device)
        self.conv2 = SameConv2d(feats, feats, 3, device=device)
        self.norm2 = group_norm(feats, device=device)

    def forward(self, x):
        x = F.gelu(self.norm1(self.conv1(x)), approximate="tanh")
        return F.gelu(self.norm2(self.conv2(x)), approximate="tanh")


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))


class DepthNet(nn.Module):
    """U-Net: 4 stride-2 encoder stages (H/16 bottleneck), a skip-connected
    decoder and a 1-channel softplus disparity head (`depthnet.py:51`)."""

    FLAX_NAMES = {**{f"ConvBlock_{i}": f"blocks.{i}" for i in range(9)}, "Conv_0": "head"}

    def __init__(self, width: int = 32, device=None):
        super().__init__()
        w = width
        chans = [(3, w, 1), (w, 2 * w, 2), (2 * w, 3 * w, 2), (3 * w, 4 * w, 2),
                 (4 * w, 4 * w, 2),  # encoder, mid at H/16
                 (8 * w, 4 * w, 1), (7 * w, 3 * w, 1), (5 * w, 2 * w, 1), (3 * w, w, 1)]
        self.blocks = nn.ModuleList([ConvBlock(a, b, s, device=device) for a, b, s in chans])
        self.head = SameConv2d(w, 1, 3, device=device)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1], H and W multiples of 16 -> (B, H, W)
        nonnegative disparity."""
        b = self.blocks
        e1 = b[0](rgb)
        e2 = b[1](e1)
        e3 = b[2](e2)
        e4 = b[3](e3)
        mid = b[4](e4)
        d4 = b[5](torch.cat([_up2(mid), e4], dim=1))
        d3 = b[6](torch.cat([_up2(d4), e3], dim=1))
        d2 = b[7](torch.cat([_up2(d3), e2], dim=1))
        d1 = b[8](torch.cat([_up2(d2), e1], dim=1))
        return F.softplus(self.head(d1)[:, 0])


def disparity_to_depth(disp: torch.Tensor, lo: float = 0.5, hi: float = 4.0) -> torch.Tensor:
    """Relative disparity (..., H, W) -> depth in [lo, hi] per image
    (`depthnet.py:163`)."""
    d = disp - disp.amin(dim=(-2, -1), keepdim=True)
    d = d / torch.clamp(d.amax(dim=(-2, -1), keepdim=True), min=1e-6)
    inv_lo, inv_hi = 1.0 / hi, 1.0 / lo
    return 1.0 / (inv_lo + d * (inv_hi - inv_lo))


def load_depthnet(path: Optional[str] = None, device="cuda") -> Optional[DepthNet]:
    """DepthNet with the shipped weights (``$VIDU4D_DEPTHNET_NPZ`` or
    ``vidu4d_tpu/weights/depthnet_synthetic.npz``) on ``device``; None
    when the file does not exist."""
    return load_net(DepthNet(), path or weights_path(WEIGHTS_ENV, WEIGHTS_FILE), device)
