"""Pinhole projection, intrinsics tuple <-> matrix helpers, near/far planes
and aabb helpers (`vidu4d_tpu/ops/geometry.py`)."""

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


def linspace01(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA computes it: i times the reciprocal
    of n - 1 rounded to ``dtype``, the last point exactly 1
    (``torch.linspace`` and a true division round some points
    differently)."""
    if n == 1:
        return torch.zeros(1, device=device, dtype=dtype)
    recip = torch.ones((), device=device, dtype=dtype) / (n - 1)
    z = torch.arange(n - 1, device=device, dtype=dtype) * recip
    return torch.cat([z, torch.ones(1, device=device, dtype=dtype)])


def obj_to_cam(pts: torch.Tensor, rtmat: torch.Tensor) -> torch.Tensor:
    """(N, 3) or (M, N, 3) points through (M, 4, 4) object-to-camera
    transforms -> (M, N, 3) (`geometry.py:126`)."""
    if pts.dim() == 2:
        pts = pts[None].expand((rtmat.shape[0],) + tuple(pts.shape))
    return torch.einsum("mij,mnj->mni", rtmat[:, :3, :3], pts) + rtmat[:, None, :3, 3]


def get_near_far(pts: torch.Tensor, rtmat: torch.Tensor, tol_fac: float = 1.5) -> torch.Tensor:
    """(M, 2) near/far planes of proxy points (N, 3) under each camera
    (M, 4, 4), widened by (tol_fac - 1) of the depth range and clamped at
    1e-3 (`geometry.py:133`)."""
    z = obj_to_cam(pts, rtmat)[..., 2]
    pmin = torch.amin(z, dim=-1)
    pmax = torch.amax(z, dim=-1)
    delta = (pmax - pmin) * (tol_fac - 1.0)
    return torch.clamp(torch.stack([pmin - delta, pmax + delta], dim=-1), min=1e-3)


def extend_aabb(aabb: torch.Tensor, factor: float = 0.1) -> torch.Tensor:
    """(2, 3) bounds grown by ``factor`` of their size on each side."""
    size = aabb[1] - aabb[0]
    return torch.stack([aabb[0] - size * factor, aabb[1] + size * factor], dim=0)


def check_inside_aabb(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    return torch.all((xyz > aabb[:1]) & (xyz < aabb[1:]), dim=-1)


def sample_grid(aabb: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(grid_size^3, 3) grid spanning the aabb, x-major (`geometry.py:164`)."""
    step = linspace01(grid_size, device=aabb.device, dtype=aabb.dtype)
    axes = [aabb[0, i] * (1 - step) + aabb[1, i] * step for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def points_aabb(pts: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.amin(pts, dim=0), torch.amax(pts, dim=0)], dim=0)


def hat_map(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vector -> (..., 3, 3) skew-symmetric matrix (`geometry.py:101`)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def so3_to_exp_map(so3: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vectors -> (..., 3, 3) rotation matrices,
    with the angle clamped to theta = max(|so3|, eps) (`geometry.py:109`).

    Below eps the angle's gradient is 0 in both packages. At exactly
    so3 = 0 the port's gradient is finite (``vector_norm`` has a 0
    subgradient there), where the JAX package's is NaN (its norm's
    infinite derivative times the clamp's 0)."""
    theta = torch.clamp(torch.linalg.vector_norm(so3, dim=-1, keepdim=True), min=eps)
    V = hat_map(so3 / theta)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=so3.dtype, device=so3.device)
    return eye + torch.sin(theta) * V + (1.0 - torch.cos(theta)) * (V @ V)


def rot_angle(mat: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 3, 3) rotation matrices (`geometry.py:175`);
    the cosine is clipped 1e-4 inside [-1, 1]."""
    eps = 1e-4
    cos = (mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0 + eps, 1.0 - eps))
