"""Fixed-capacity Gaussian-surfel parameter store
(`vidu4d_tpu/models/gaussian/surfels.py`).

Surfels live in a static-capacity struct of tensors with an ``alive`` mask.
Parameterization: scaling = exp(raw) (2 tangent axes), opacity =
sigmoid(raw), rotation = normalize(raw) (w, x, y, z), colour = SH with
features_dc (N, 1, 3) + features_rest (N, K-1, 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from vidu4d_tpu_torch.ops import sh as sh_ops
from vidu4d_tpu_torch.ops.knn import mean_knn_sq_dist
from vidu4d_tpu_torch.ops.numerics import safe_normalize


class SurfelParams(NamedTuple):
    """The optimizable leaves (all first-dim = capacity)."""

    xyz: torch.Tensor  # (N, 3)
    features_dc: torch.Tensor  # (N, 1, 3)
    features_rest: torch.Tensor  # (N, K-1, 3)
    scaling: torch.Tensor  # (N, 2) log-scale
    rotation: torch.Tensor  # (N, 4) unnormalized quaternion (w, x, y, z)
    opacity: torch.Tensor  # (N, 1) pre-sigmoid
    regist_feat: torch.Tensor  # (N, F) registration features (F = 0 if unused)


class SurfelState(NamedTuple):
    params: SurfelParams
    alive: torch.Tensor  # (N,) bool
    max_radii2d: torch.Tensor  # (N,) max screen radius since the last densify
    grad_accum: torch.Tensor  # (N,) accumulated viewspace grad norms
    denom: torch.Tensor  # (N,) number of accumulation events

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))


def get_scaling(p: SurfelParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_opacity(p: SurfelParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_rotation(p: SurfelParams) -> torch.Tensor:
    return safe_normalize(p.rotation)


def get_features(p: SurfelParams) -> torch.Tensor:
    """(N, K, 3) SH coefficients."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def init_from_points(
    points: torch.Tensor,
    colors: torch.Tensor,
    capacity: int,
    sh_degree: int = 3,
    generator: Optional[torch.Generator] = None,
    regist_feat: Optional[torch.Tensor] = None,
    init_opacity: float = 0.1,
) -> SurfelState:
    """Surfels from a coloured point cloud (`surfels.py:78`): SH DC from RGB,
    log-scale from sqrt(mean 3-NN squared distance), uniform random
    rotations drawn from ``generator``, opacity 0.1. Points beyond
    ``capacity`` are dropped; the remainder are dead slots. The leaves are
    new tensors on ``points.device`` that require grad."""
    n = points.shape[0]
    if n > capacity:
        points, colors = points[:capacity], colors[:capacity]
        if regist_feat is not None:
            regist_feat = regist_feat[:capacity]
        n = capacity
    dev, dt = points.device, points.dtype
    n_coeffs = sh_ops.num_sh_coeffs(sh_degree)
    dc = sh_ops.rgb_to_sh(colors)[:, None, :]
    rest = torch.zeros((n, n_coeffs - 1, 3), dtype=dt, device=dev)
    dist2 = torch.clamp(mean_knn_sq_dist(points, k=3), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 2)
    rots = torch.rand((n, 4), generator=generator, dtype=dt, device=dev)
    opac = torch.full((n, 1), math.log(init_opacity / (1.0 - init_opacity)),
                      dtype=dt, device=dev)
    rfeat = (torch.zeros((n, 0), dtype=dt, device=dev) if regist_feat is None
             else regist_feat)

    def pad(x):
        out = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=dt, device=dev)
        out[:n] = x
        return out

    rotation = pad(rots)
    rotation[n:, 0] = 1.0  # dead slots: identity quats
    params = SurfelParams(
        xyz=pad(points), features_dc=pad(dc), features_rest=pad(rest),
        scaling=pad(scales), rotation=rotation, opacity=pad(opac),
        regist_feat=pad(rfeat),
    )
    params = SurfelParams(*[p.detach().requires_grad_(True) for p in params])
    zeros = torch.zeros(capacity, dtype=dt, device=dev)
    return SurfelState(
        params=params, alive=torch.arange(capacity, device=dev) < n,
        max_radii2d=zeros, grad_accum=zeros.clone(), denom=zeros.clone(),
    )
