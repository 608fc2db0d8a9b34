"""Pseudo surface normals from a rendered depth map
(`vidu4d_tpu/ops/depth_normal.py`).

Unproject the depth map to camera-space points, take central-difference
tangents, normal = their normalised cross product, zero on the 1-px
border. The functions take one frame, depth (H, W) and intrinsics (4,), or
a batch of frames, depth (..., H, W) and intrinsics (..., 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_to_points_cam(depth: torch.Tensor, intrins: torch.Tensor) -> torch.Tensor:
    """depth (..., H, W) + intrinsics (..., 4) (fx, fy, cx, cy) -> camera
    points (..., H, W, 3)."""
    h, w = depth.shape[-2:]
    fx, fy, cx, cy = (intrins[..., i, None, None] for i in range(4))
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    rx = (gx - cx) / fx
    ry = (gy - cy) / fy
    rays = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    return rays * depth[..., None]


def depth_to_normal_cam(depth: torch.Tensor, intrins: torch.Tensor) -> torch.Tensor:
    """Depth map -> camera-space pseudo normals (..., H, W, 3), zero border:
    dx along image rows, dy along columns, n = normalize(dx x dy)."""
    points = depth_to_points_cam(depth, intrins)
    dx = points[..., 2:, 1:-1, :] - points[..., :-2, 1:-1, :]
    dy = points[..., 1:-1, 2:, :] - points[..., 1:-1, :-2, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True), min=1e-24))
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def surf_depth_and_normal(depth_expected: torch.Tensor, depth_median: torch.Tensor,
                          alpha: torch.Tensor, intrins: torch.Tensor,
                          depth_ratio: float = 0.0):
    """Surface depth (mix of the alpha-normalised expected depth and the
    median depth) and its pseudo normal weighted by the detached alpha
    (`depth_normal.py:42`)."""
    surf_depth = depth_expected * (1.0 - depth_ratio) + depth_ratio * depth_median
    surf_normal = depth_to_normal_cam(surf_depth, intrins) * alpha.detach()[..., None]
    return surf_depth, surf_normal
