"""Per-splat projection and tile binning for the 2DGS surfel rasterizer
(`vidu4d_tpu/ops/rasterize/common.py`).

Projection is plain differentiable tensor code. Binning follows the JAX
package's fused one-sort `bin_splats_aligned` contract:

* each splat emits a fixed number of tile entries (a centred clamp of its
  AABB tile rect), in two pools: every splat's 2x2 clamp, plus the full
  ``span_cap**2`` rect for up to ``P // 16`` large splats;
* one stable int32 key sort ``tile << depth_bits | depth_code`` orders
  entries by (tile, depth); real depth codes clip to ``2**depth_bits - 2``;
* pad entries (splat id 0) fill each tile segment up to a ``chunk``
  boundary, so segments start on a multiple of ``chunk`` and pad slots sit
  outside ``[start, start + count)``;
* ``entry_cap`` keeps the first ``round_up(entry_cap) + T * chunk`` slots.

Per-tile counts come from ``torch.bincount`` of the emitted keys (the JAX
package's MXU corner histogram is a TPU device and is not ported).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from vidu4d_tpu_torch.ops.quaternion import quaternion_to_matrix

# constants pinned by the reference (auxiliary.h:20-37, config.h:15-17)
FILTER_SIZE = 0.7071067811865476
FILTER_INV_SQUARE = 1.0 / (FILTER_SIZE * FILTER_SIZE)
NEAR_PLANE = 0.2
FAR_PLANE = 100.0
ALPHA_EPS = 1.0 / 255.0
T_EARLY_STOP = 1e-4
ALPHA_CLAMP = 0.99


class SplatProjection(NamedTuple):
    """Per-splat screen-space quantities, each (..., P, ...)."""

    tu: torch.Tensor  # (..., P, 3) transMat row u
    tv: torch.Tensor  # (..., P, 3) transMat row v
    tw: torch.Tensor  # (..., P, 3) transMat row w (depth row)
    normal: torch.Tensor  # (..., P, 3) camera-space normal (dual-visible flip)
    center2d: torch.Tensor  # (..., P, 2) AABB centre
    extent2d: torch.Tensor  # (..., P, 2) AABB half-extent (1 sigma)
    radius: torch.Tensor  # (..., P) pixel radius (3 sigma, >= FILTER_SIZE)
    depth: torch.Tensor  # (..., P) camera-space centre depth
    valid: torch.Tensor  # (..., P) bool


def _safe_sqrt(z: torch.Tensor) -> torch.Tensor:
    # double-where: zero value and zero gradient on the clamped branch
    pos = z > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, z, torch.ones_like(z))),
                       torch.zeros_like(z))


def project_splats(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    viewmat: torch.Tensor,
    intrins: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    densify_dummy: Optional[torch.Tensor] = None,
) -> SplatProjection:
    """Project 2D Gaussian surfels to screen space (`common.py:54`).

    means3d (..., P, 3), quats (..., P, 4), scales (P, 2) or (..., P, 2),
    viewmat (4, 4), intrins (..., 4) with the same leading dims as means3d
    (one camera per frame), mask (P,) bool, densify_dummy (..., P, 2) zeros
    whose gradient is the reference's viewspace densification signal.
    """
    rot_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]
    p_view = means3d @ rot_wc.T + t_wc  # (..., P, 3)

    rmat = quaternion_to_matrix(quats)  # (..., P, 3, 3), columns = tangent axes
    axes_cam = torch.einsum("ij,...jk->...ik", rot_wc, rmat)
    a = axes_cam[..., 0] * scales[..., 0:1]
    b = axes_cam[..., 1] * scales[..., 1:2]
    tn = axes_cam[..., 2]

    cos = -torch.sum(tn * p_view, dim=-1, keepdim=True)
    normal = torch.where(cos > 0, tn, -tn)

    k = intrins[..., None, :]  # (..., 1, 4) broadcasts over P
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    tw = torch.stack([a[..., 2], b[..., 2], p_view[..., 2]], dim=-1)
    tu = fx[..., None] * torch.stack([a[..., 0], b[..., 0], p_view[..., 0]], dim=-1) \
        + cx[..., None] * tw
    tv = fy[..., None] * torch.stack([a[..., 1], b[..., 1], p_view[..., 1]], dim=-1) \
        + cy[..., None] * tw

    if densify_dummy is not None:
        zero = torch.zeros_like(densify_dummy[..., :1])
        tu = tu + torch.cat([zero, zero, densify_dummy[..., 0:1]], dim=-1)
        tv = tv + torch.cat([zero, zero, densify_dummy[..., 1:2]], dim=-1)

    sgn = torch.tensor([1.0, 1.0, -1.0], dtype=means3d.dtype, device=means3d.device)
    d = torch.sum(sgn * tw * tw, dim=-1, keepdim=True)
    d_safe = torch.where(torch.abs(d) < 1e-12, torch.ones_like(d), d)
    f = sgn / d_safe
    cx2d = torch.sum(f * tu * tw, dim=-1)
    cy2d = torch.sum(f * tv * tw, dim=-1)
    hx = _safe_sqrt(cx2d * cx2d - torch.sum(f * tu * tu, dim=-1))
    hy = _safe_sqrt(cy2d * cy2d - torch.sum(f * tv * tv, dim=-1))
    center2d = torch.stack([cx2d, cy2d], dim=-1)
    extent2d = torch.stack([hx, hy], dim=-1)
    radius = torch.ceil(
        3.0 * torch.clamp(torch.amax(extent2d, dim=-1), min=FILTER_SIZE)
    )

    valid = (p_view[..., 2] > NEAR_PLANE) & (torch.abs(d[..., 0]) >= 1e-12) \
        & (cos[..., 0] != 0)
    finite = (
        torch.isfinite(center2d).all(dim=-1)
        & torch.isfinite(extent2d).all(dim=-1)
        & (torch.abs(center2d) < 1e7).all(dim=-1)
        & (extent2d < 1e7).all(dim=-1)
    )
    valid = valid & finite
    if mask is not None:
        valid = valid & mask
    return SplatProjection(
        tu=tu, tv=tv, tw=tw, normal=normal, center2d=center2d,
        extent2d=extent2d, radius=radius, depth=p_view[..., 2], valid=valid,
    )


def quantize_depth(depth: torch.Tensor, depth_bits: int,
                   near: float = NEAR_PLANE, far: float = FAR_PLANE) -> torch.Tensor:
    """Monotone int quantization of depth for compound sort keys."""
    t = torch.clamp((depth - near) / (far - near), 0.0, 1.0)
    return (t * ((1 << depth_bits) - 1)).to(torch.int32)


def tile_grid_shape(height: int, width: int, tile: int) -> Tuple[int, int]:
    return -(-height // tile), -(-width // tile)


class TileRects(NamedTuple):
    min_x: torch.Tensor  # (..., P) int32
    min_y: torch.Tensor
    span_x: torch.Tensor  # (..., P) int32, <= span_cap
    span_y: torch.Tensor
    valid: torch.Tensor  # (..., P) bool: projection-valid AND non-empty rect
    overflow: torch.Tensor  # (..., P) bool: rect was clamped to span_cap


def compute_tile_rects(proj: SplatProjection, height: int, width: int,
                       tile: int, span_cap: int) -> TileRects:
    """Per-splat covered-tile rect, centred-clamped to at most span_cap
    tiles per axis (`common.py:182`)."""
    tiles_y, tiles_x = tile_grid_shape(height, width, tile)
    cx = proj.center2d[..., 0]
    cy = proj.center2d[..., 1]
    r = proj.radius
    i32 = torch.int32

    def rect(c, n):
        lo = torch.clamp(torch.floor((c - r) / tile), 0, n).to(i32)
        hi = torch.clamp(torch.floor((c + r + tile - 1) / tile), 0, n).to(i32)
        return lo, hi

    min_x, max_x = rect(cx, tiles_x)
    min_y, max_y = rect(cy, tiles_y)
    span_x = max_x - min_x
    span_y = max_y - min_y
    overflow = (span_x > span_cap) | (span_y > span_cap)

    # float -> int32 truncates toward zero like jnp's astype
    ctile_x = torch.clamp((cx / tile).to(i32), 0, tiles_x - 1)
    ctile_y = torch.clamp((cy / tile).to(i32), 0, tiles_y - 1)

    def clamp_span(rmin, rmax, span, ctile):
        hi = torch.maximum(rmax - span_cap, rmin)
        lo = torch.minimum(torch.maximum(ctile - span_cap // 2, rmin), hi)
        new_min = torch.where(span > span_cap, lo, rmin)
        return new_min, torch.clamp(span, max=span_cap)

    min_x, span_x = clamp_span(min_x, max_x, span_x, ctile_x)
    min_y, span_y = clamp_span(min_y, max_y, span_y, ctile_y)
    empty = (span_x == 0) | (span_y == 0)
    return TileRects(min_x=min_x, min_y=min_y, span_x=span_x, span_y=span_y,
                     valid=proj.valid & ~empty, overflow=overflow)


class TileBinning(NamedTuple):
    sorted_splat_ids: torch.Tensor  # (E,) int64, entries sorted by (tile, depth)
    sorted_tile_ids: torch.Tensor  # (E,) int32 tile of each entry (T = pad)
    tile_start: torch.Tensor  # (T,) int32 first slot of each tile segment
    tile_count: torch.Tensor  # (T,) int32 real entries per tile
    num_entries: torch.Tensor  # () int32 total real entries
    overflowed: torch.Tensor  # () int32 splats whose tile span was clamped


def bin_splats_aligned(
    proj: SplatProjection,
    height: int,
    width: int,
    tile: int = 16,
    span_cap: int = 4,
    chunk: int = 128,
    entry_cap: int = 0,
) -> TileBinning:
    """One-frame fused binning + cap + chunk alignment (`common.py:407`);
    the output layout is the JAX function's exactly (see module docstring)."""
    tiles_y, tiles_x = tile_grid_shape(height, width, tile)
    num_tiles = tiles_x * tiles_y
    tile_bits = max(1, math.ceil(math.log2(max(num_tiles, 2))))
    depth_bits = 30 - tile_bits
    if depth_bits < 12:
        raise ValueError(
            f"too many tiles ({num_tiles}) for int32 keys; increase tile size"
        )
    dev = proj.depth.device
    i32 = torch.int32
    p = proj.center2d.shape[0]
    rects = compute_tile_rects(proj, height, width, tile, span_cap)
    depth_max = (1 << depth_bits) - 2
    depth_q = torch.clamp(quantize_depth(proj.depth, depth_bits), max=depth_max)
    sentinel = num_tiles << depth_bits

    def emit(min_x, min_y, span_x, span_y, valid, dq, cap):
        j = torch.arange(cap * cap, dtype=i32, device=dev)
        sx = torch.clamp(span_x, min=1)[:, None]
        dx = j[None, :] % sx
        dy = j[None, :] // sx
        in_rect = (dy < span_y[:, None]) & valid[:, None]
        tile_id = (min_y[:, None] + dy) * tiles_x + (min_x[:, None] + dx)
        keys = (tile_id << depth_bits) | dq[:, None]
        return torch.where(in_rect, keys, torch.full_like(keys, sentinel)).reshape(-1)

    small = 2
    arange_p = torch.arange(p, dtype=torch.int64, device=dev)
    if span_cap <= small:
        keys = emit(rects.min_x, rects.min_y, rects.span_x, rects.span_y,
                    rects.valid, depth_q, span_cap)
        splat_ids = arange_p.repeat_interleave(span_cap * span_cap)
        overflowed = torch.sum((rects.overflow & rects.valid).to(i32))
    else:
        # two-pool emission (`common.py:476-518`): every splat's 2x2 clamp,
        # plus the full span_cap rect for the first big_cap large splats
        rects2 = compute_tile_rects(proj, height, width, tile, small)
        is_big = rects.valid & ((rects.span_x > small) | (rects.span_y > small))
        big_cap = min(p, max(32, p // 16))
        rank = torch.cumsum(is_big.to(i32), 0) - 1
        in_pool = is_big & (rank < big_cap)
        pool_key = torch.where(in_pool, rank, torch.full_like(rank, p))
        big_ids = torch.sort(pool_key, stable=True).indices[:big_cap]
        n_big = torch.sum(is_big.to(i32))
        slot_valid = torch.arange(big_cap, dtype=i32, device=dev) < torch.clamp(
            n_big, max=big_cap)
        keys_small = emit(rects2.min_x, rects2.min_y, rects2.span_x,
                          rects2.span_y, rects2.valid & ~in_pool, depth_q, small)
        keys_big = emit(rects.min_x[big_ids], rects.min_y[big_ids],
                        rects.span_x[big_ids], rects.span_y[big_ids],
                        slot_valid, depth_q[big_ids], span_cap)
        keys = torch.cat([keys_small, keys_big])
        splat_ids = torch.cat([
            arange_p.repeat_interleave(small * small),
            big_ids.repeat_interleave(span_cap * span_cap),
        ])
        overflowed = torch.sum((rects.overflow & rects.valid).to(i32)) \
            + torch.clamp(n_big - big_cap, min=0)

    # per-tile counts of the emitted real entries (sentinels land in bin T)
    hist = torch.bincount((keys >> depth_bits).long(),
                          minlength=num_tiles + 1)[:num_tiles].to(i32)
    padded = (hist + chunk - 1) // chunk * chunk
    gap = padded - hist  # pads used per tile, in [0, chunk)
    astart = torch.cumsum(padded, 0, dtype=i32) - padded

    # pad entries: key (t << db | db_max + 1) lands after every real entry
    # of tile t; unused pads get sentinel keys
    jj = torch.arange(chunk, dtype=i32, device=dev)
    tile_key = (torch.arange(num_tiles, dtype=i32, device=dev)[:, None]
                << depth_bits) | (depth_max + 1)
    pad_keys = torch.where(jj[None, :] < gap[:, None], tile_key,
                           torch.full_like(tile_key, sentinel)).reshape(-1)
    all_keys = torch.cat([keys, pad_keys])
    all_ids = torch.cat([splat_ids, torch.zeros(num_tiles * chunk,
                                                dtype=torch.int64, device=dev)])
    # sentinel emissions land as id-0 pads
    all_ids = torch.where(all_keys == sentinel, torch.zeros_like(all_ids), all_ids)
    keys_sorted, order = torch.sort(all_keys, stable=True)
    ids_sorted = all_ids[order]
    tile_of_entry = torch.clamp(keys_sorted >> depth_bits, max=num_tiles)

    start, count = astart, hist
    if entry_cap:
        cap = -(-entry_cap // chunk) * chunk + num_tiles * chunk
        if cap < ids_sorted.shape[0]:
            start = torch.clamp(astart, max=cap)
            count = torch.clamp(astart + hist, max=cap) - start
            ids_sorted = ids_sorted[:cap]
            tile_of_entry = tile_of_entry[:cap]
    return TileBinning(
        sorted_splat_ids=ids_sorted,
        sorted_tile_ids=tile_of_entry.to(i32),
        tile_start=start,
        tile_count=count,
        num_entries=torch.sum(hist),
        overflowed=overflowed,
    )
