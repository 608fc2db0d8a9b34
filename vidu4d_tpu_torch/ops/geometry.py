"""Pinhole projection and intrinsics tuple <-> matrix helpers
(`vidu4d_tpu/ops/geometry.py`)."""

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


def hxy_grid(H: int, W: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel-centre grid, (H*W, 3) rows of (x, y, 1) in raster
    order (`geometry.py:88`)."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1).reshape(-1, 3)


def pinhole_projection(Kmat: torch.Tensor, xyz_cam: torch.Tensor) -> torch.Tensor:
    """Camera-space points (M, ..., 3) -> homogeneous pixel coordinates
    (M, ..., 3) under intrinsics (M, 3, 3) (`geometry.py:20`). The
    denominator is clamped to |z| >= 1e-3 with its sign kept, so a point
    crossing the camera plane gives finite values and gradients."""
    shape = xyz_cam.shape
    Kmat = Kmat.reshape(shape[:1] + (1,) * (len(shape) - 2) + (3, 3))
    hxy = torch.sum(Kmat * xyz_cam[..., None, :], dim=-1)
    z = hxy[..., -1:]
    z_safe = torch.where(z.abs() < 1e-3,
                         torch.where(z < 0, -1e-3, 1e-3).to(z.dtype), z)
    return hxy / z_safe
