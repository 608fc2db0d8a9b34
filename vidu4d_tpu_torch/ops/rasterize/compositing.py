"""Per-pixel splat response + front-to-back alpha compositing
(`vidu4d_tpu/ops/rasterize/compositing.py`).

Used by the naive oracle (`reference.py`) and the tests; the training path
composites in the tile kernels (`tile_forward.py`, `tile_backward.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vidu4d_tpu_torch.ops.rasterize.common import (
    ALPHA_CLAMP,
    ALPHA_EPS,
    FAR_PLANE,
    FILTER_INV_SQUARE,
    NEAR_PLANE,
    T_EARLY_STOP,
)


class CompositeOutput(NamedTuple):
    color: torch.Tensor  # (..., C) composited colour incl. background
    depth: torch.Tensor  # expected depth
    alpha: torch.Tensor  # accumulated opacity (1 - final T)
    normal: torch.Tensor  # (..., 3)
    median_depth: torch.Tensor
    distortion: torch.Tensor
    median_weight: torch.Tensor
    final_t: torch.Tensor


def splat_pixel_response(tu, tv, tw, center2d, opacity, pix):
    """Splat alpha and intersection depth at pixel centres (direct
    cross-product form, `forward.cu:359-385`). Shapes broadcast."""
    px = pix[..., 0:1]
    py = pix[..., 1:2]
    k = px * tw - tu
    l = py * tw - tv
    k, l = torch.broadcast_tensors(k, l)
    p = torch.linalg.cross(k, l, dim=-1)
    pz = p[..., 2]
    pz_ok = pz != 0.0
    pz_safe = torch.where(pz_ok, pz, torch.ones_like(pz))
    sx = torch.clamp(p[..., 0] / pz_safe, -1e6, 1e6)
    sy = torch.clamp(p[..., 1] / pz_safe, -1e6, 1e6)
    rho3d = sx * sx + sy * sy
    dx = center2d[..., 0] - px[..., 0]
    dy = center2d[..., 1] - py[..., 0]
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(rho3d <= rho2d,
                        sx * tw[..., 0] + sy * tw[..., 1] + tw[..., 2],
                        tw[..., 2].expand_as(rho3d))
    alpha = torch.clamp(opacity * torch.exp(-0.5 * rho), max=ALPHA_CLAMP)
    ok = pz_ok & (depth >= NEAR_PLANE) & (alpha >= ALPHA_EPS)
    zero = torch.zeros_like(alpha)
    return torch.where(ok, alpha, zero), torch.where(ok, depth, zero)


def composite(alpha, depth, color, normal, bg_color) -> CompositeOutput:
    """Front-to-back compositing of (K, N) alphas in depth order, as prefix
    ops (cumprod transmittance, monotone T >= 1e-4 include mask)."""
    t_incl = torch.cumprod(1.0 - alpha, dim=0)
    t_prefix = torch.cat([torch.ones_like(t_incl[:1]), t_incl[:-1]], dim=0)
    include = t_incl >= T_EARLY_STOP
    w = alpha * t_prefix * include.to(alpha.dtype)

    final_t = torch.amin(torch.where(include, t_incl, torch.ones_like(t_incl)), dim=0)
    color_out = torch.einsum("kn,knc->nc", w, color.expand(w.shape + color.shape[-1:]))
    color_out = color_out + final_t[:, None] * bg_color[None, :]
    normal_out = torch.einsum("kn,knc->nc", w, normal.expand(w.shape + (3,)))
    depth_out = torch.sum(w * depth, dim=0)

    depth_pos = torch.clamp(depth, min=1e-6)
    m = (FAR_PLANE * depth_pos - FAR_PLANE * NEAR_PLANE) / (
        (FAR_PLANE - NEAR_PLANE) * depth_pos)
    wm = w * m
    wmm = w * m * m
    dist1 = torch.cumsum(wm, dim=0) - wm
    dist2 = torch.cumsum(wmm, dim=0) - wmm
    error = m * m * (1.0 - t_prefix) + dist2 - 2.0 * m * dist1
    distortion = torch.sum(w * error, dim=0)

    # median: last composited splat with T (before) > 0.5
    cand = (w > 0) & (t_prefix > 0.5)
    k = alpha.shape[0]
    ranks = torch.arange(k, device=alpha.device)[:, None].expand_as(cand)
    idx = torch.amax(torch.where(cand, ranks, torch.full_like(ranks, -1)), dim=0)
    has = idx >= 0
    idx = torch.clamp(idx, min=0)[None]
    zero = torch.zeros_like(depth_out)
    median_depth = torch.where(has, torch.gather(depth, 0, idx)[0], zero)
    median_weight = torch.where(has, torch.gather(w, 0, idx)[0], zero)
    return CompositeOutput(
        color=color_out, depth=depth_out, alpha=1.0 - final_t,
        normal=normal_out, median_depth=median_depth, distortion=distortion,
        median_weight=median_weight, final_t=final_t,
    )
