"""LPIPS perceptual distance (`vidu4d_tpu/ops/lpips.py`; the reference's
`gs/lpipsPyTorch/`): VGG16 conv features at 5 taps (relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3), unit-normalised over channels, squared
differences, "lin" weights per channel, averaged over space and summed over
taps.

Weights, in order of preference:

1. an .npz at ``weights_path`` / $VIDU4D_LPIPS_NPZ in the JAX package's
   schema: ``conv{i}_{j}_w`` ((kh, kw, cin, cout) float32, transposed here
   to torch's (cout, cin, kh, kw)), ``conv{i}_{j}_b`` and optional
   ``lin{k}_w`` ((C_k,) nonnegative); kind "vgg16-pretrained";
2. otherwise the port's own pinned fallback: He-init from
   ``torch.Generator().manual_seed(0)`` with uniform 1/C lin weights; kind
   "vgg16-random-pinned-torch". Its filters differ from the JAX fallback's
   (``PRNGKey(0)``), so its values are comparable only with itself, and
   neither is comparable with published LPIPS(vgg) numbers.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv layout: (name, out_channels); "M" = 2x2 max pool
_VGG16 = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]
_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")

# input scaling of the official LPIPS implementation (images in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

PRETRAINED = "vgg16-pretrained"
FALLBACK = "vgg16-random-pinned-torch"


def _weights_file(weights_path: Optional[str] = None) -> str:
    """The weights file to load ("" for the fallback)."""
    path = weights_path or os.environ.get("VIDU4D_LPIPS_NPZ", "")
    return path if path and os.path.exists(path) else ""


def load_params(weights_path: Optional[str] = None):
    """(params dict of numpy arrays in the JAX schema, kind), or (None,
    FALLBACK) when no weights file is given or found."""
    path = _weights_file(weights_path)
    if not path:
        return None, FALLBACK
    data = np.load(path)
    return {k: data[k] for k in data.files}, PRETRAINED


class LPIPSNet(nn.Module):
    """The VGG16 graph of JAX `_features` / `_lpips_impl` (`lpips.py:75-112`):
    3x3 convolutions with padding 1, ReLU, 2x2 max pools (floor), taps
    unit-normalised over channels, lin weights (or 1/C)."""

    def __init__(self, params: Optional[Dict[str, np.ndarray]] = None):
        super().__init__()
        self.convs = nn.ModuleDict()
        gen = torch.Generator().manual_seed(0)  # pinned: the same metric everywhere
        cin = 3
        for item in _VGG16:
            if item == "M":
                continue
            name, cout = item
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            with torch.no_grad():
                if params is None:
                    conv.weight.copy_(torch.randn((cout, cin, 3, 3), generator=gen)
                                      * float(np.sqrt(2.0 / (9 * cin))))
                    conv.bias.zero_()
                else:
                    conv.weight.copy_(torch.tensor(
                        np.asarray(params[f"{name}_w"], np.float32).transpose(3, 2, 0, 1)))
                    conv.bias.copy_(torch.tensor(np.asarray(params[f"{name}_b"], np.float32)))
            self.convs[name] = conv
            cin = cout
        for i, name in enumerate(_TAPS):
            lin = None if params is None else params.get(f"lin{i}_w")
            if lin is None:
                lin = np.full(self.convs[name].out_channels, 1.0 / self.convs[name].out_channels)
            self.register_buffer(f"lin{i}", torch.tensor(np.asarray(lin, np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None])
        self.requires_grad_(False)

    def features(self, x: torch.Tensor):
        """x (N, 3, H, W) in [-1, 1] -> the 5 tap activations."""
        x = (x - self.shift) / self.scale
        taps = []
        for item in _VGG16:
            if item == "M":
                x = F.max_pool2d(x, 2)
                continue
            name, _ = item
            x = F.relu(self.convs[name](x))
            if name in _TAPS:
                taps.append(x)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0, img1 (N, 3, H, W) in [-1, 1] -> scalar distance (mean over
        N and space, sum over taps). Images below 16 pixels a side raise:
        the fourth pool leaves no pixel (JAX's mean over the empty tap is
        NaN)."""
        if min(img0.shape[-2:]) < 16:
            raise ValueError(f"LPIPS needs images of at least 16 x 16 pixels, got "
                             f"{tuple(img0.shape[-2:])}")
        total = img0.new_zeros(())
        for i, (a, b) in enumerate(zip(self.features(img0), self.features(img1))):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            d = (a - b) ** 2
            lin = getattr(self, f"lin{i}")
            total = total + torch.mean(torch.sum(d * lin[None, :, None, None], dim=1))
        return total


class LPIPS:
    """Callable LPIPS metric on ``device``. Images (H, W, 3) or (N, H, W, 3)
    in [0, 1], numpy or tensors."""

    def __init__(self, weights_path: Optional[str] = None, device="cpu"):
        params, self.kind = load_params(weights_path)
        self.device = torch.device(device)
        self.net = LPIPSNet(params).to(self.device)

    @torch.no_grad()
    def __call__(self, img0, img1) -> float:
        def nchw(img):
            x = torch.as_tensor(img, dtype=torch.float32, device=self.device)
            x = x[None] if x.dim() == 3 else x
            return x.permute(0, 3, 1, 2) * 2 - 1  # [0, 1] -> [-1, 1]
        return float(self.net(nchw(img0), nchw(img1)))


_default: Dict[str, LPIPS] = {}


def lpips(img0, img1) -> float:
    """LPIPS with the default weights, on the device of ``img0`` (the CPU
    for numpy arrays); one cached instance per device."""
    dev = str(img0.device) if torch.is_tensor(img0) else "cpu"
    if dev not in _default:
        _default[dev] = LPIPS(device=dev)
    return _default[dev](img0, img1)


def lpips_kind() -> str:
    """The kind of the default weights ($VIDU4D_LPIPS_NPZ or the fallback)."""
    return PRETRAINED if _weights_file() else FALLBACK
