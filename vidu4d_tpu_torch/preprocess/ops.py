"""Image sampling for preprocessing and TSDF fusion
(`vidu4d_tpu/preprocess/ops.py`): `bilinear_sample`, the only function of
that module the port needs so far."""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at float pixel coordinates x, y (...,); clamps
    at the borders (`ops.py:17`).

    The coordinates clip to [0, w - 1.000001], which rounds to exactly
    w - 1 in float32 once w >= 256; then x0 + 1 == w. JAX clamps that
    out-of-range gather (its weight is 0); here the neighbour index is
    clamped to the last row / column, which gives the same value."""
    h, w = img.shape[:2]
    x = torch.clamp(x, 0.0, w - 1.000001)
    y = torch.clamp(y, 0.0, h - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)
