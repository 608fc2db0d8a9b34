"""Intrinsics tuple <-> matrix helpers (`vidu4d_tpu/ops/geometry.py`)."""

from __future__ import annotations

import torch


def K2mat(K: torch.Tensor) -> torch.Tensor:
    """(..., 4) intrinsics tuple (fx, fy, cx, cy) -> (..., 3, 3) matrix."""
    fx, fy, cx, cy = K.unbind(-1)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = torch.stack([fx, zero, cx, zero, fy, cy, zero, zero, one], dim=-1)
    return rows.reshape(K.shape[:-1] + (3, 3))


def mat2K(Kmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) intrinsics matrix -> (..., 4) tuple (fx, fy, cx, cy)."""
    return torch.stack(
        [Kmat[..., 0, 0], Kmat[..., 1, 1], Kmat[..., 0, 2], Kmat[..., 1, 2]],
        dim=-1,
    )


def K2inv(K: torch.Tensor) -> torch.Tensor:
    """(..., 4) intrinsics tuple -> (..., 3, 3) inverse intrinsics matrix."""
    fx, fy, cx, cy = K.unbind(-1)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    rows = torch.stack(
        [1.0 / fx, zero, -cx / fx, zero, 1.0 / fy, -cy / fy, zero, zero, one],
        dim=-1,
    )
    return rows.reshape(K.shape[:-1] + (3, 3))


def Kmatinv(Kmat: torch.Tensor) -> torch.Tensor:
    return K2inv(mat2K(Kmat))
