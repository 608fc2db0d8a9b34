"""Spherical-harmonics colour evaluation, degree 0..3 (`vidu4d_tpu/ops/sh.py`).

Storage layout matches 3DGS: ``sh[..., K, 3]`` with ``K = (deg+1)**2``.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH values at unit directions: sh (..., K, C), dirs (..., 3) -> (..., C)."""
    if not 0 <= deg <= 3:
        raise ValueError(f"unsupported SH degree {deg}")
    result = C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
                  - C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4, :]
                + C2[1] * yz * sh[..., 5, :]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + C2[3] * xz * sh[..., 7, :]
                + C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                    + C3[1] * xy * z * sh[..., 10, :]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12, :]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                    + C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15, :]
                )
    return result


def eval_sh_color(deg: int, sh: torch.Tensor, means: torch.Tensor,
                  cam_pos: torch.Tensor) -> torch.Tensor:
    """SH -> RGB as the rasterizer preprocess does: view direction from the
    camera centre to the splat, +0.5 shift, clamp at 0."""
    dirs = means - cam_pos
    dirs = dirs / torch.sqrt(
        torch.clamp(torch.sum(dirs * dirs, dim=-1, keepdim=True), min=1e-24)
    )
    return torch.clamp(eval_sh(deg, sh, dirs) + 0.5, min=0.0)
