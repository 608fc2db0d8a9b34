"""Rendering of the surfels, written plainly: spherical-harmonics colour,
the 2D Gaussian surfel projection, which tiles each surfel reaches, and a
dense compositor that sorts every pixel's surfels by depth and blends them
front to back.

What reaches a pixel is the configured rasterizer's rule (tile 16, a
surfel's 3-sigma box of tiles, clamped about its centre to 2 x 2 tiles, or
to ``span_cap`` x ``span_cap`` for the first P / 16 larger ones, and the
entry cap of each frame); in which order, the surfel's centre depth
quantised to the tile key's bits, ties by the order of emission. Then each
(surfel, pixel) pair is blended as 2DGS does: the ray-splat intersection
or, where nearer, the 2D low-pass of radius 1/sqrt(2) px about the
projected centre; alpha = min(opacity G, 0.99), skipped below 1/255 or
nearer than 0.2; a pixel stops before the surfel that would take its
transmittance below 1e-4. The transmittance is carried in float64.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
LOWPASS_INV2 = 2.0     # 1 / (1/sqrt(2))^2
NEAR, FAR = 0.2, 100.0
ALPHA_MIN, ALPHA_MAX, T_MIN = 1.0 / 255.0, 0.99, 1e-4
TILE, CHUNK = 16, 128  # the tile side; tiles' entry lists start on CHUNK slots
SMALL_SPAN = 2


def sh_colour(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-3 SH (P, 16, 3) at view directions (M, P, 3) -> RGB >= 0."""
    d = dirs / torch.sqrt(torch.clamp(torch.sum(dirs * dirs, -1, keepdim=True), min=1e-24))
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    xx, yy, zz = x * x, y * y, z * z
    basis = [SH_C0 + 0 * x, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
             SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    rgb = sum(b * sh[:, k] for k, b in enumerate(basis)) + 0.5
    return torch.maximum(rgb, rgb.new_zeros(()))


def project(xyz, rot, scale, K, alive, dummy=None) -> Dict[str, torch.Tensor]:
    """Surfels in camera space (M, P, 3), their rotation matrices (M, P,
    3, 3) and scales (P, 2) under pinhole intrinsics K (M, 4): the rows of
    the splat-to-screen map (tu, tv, tw), the facing normal, the screen
    box (centre, 1-sigma half extents, 3-sigma radius in whole pixels), the
    depth and the validity. ``dummy`` (M, P, 2) is added to the screen
    position's constant column; its gradient is the densification signal."""
    a = rot[..., 0] * scale[:, 0:1]
    b = rot[..., 1] * scale[:, 1:2]
    n = rot[..., 2]
    cos = -torch.sum(n * xyz, -1, keepdim=True)
    normal = torch.where(cos > 0, n, -n)
    fx, fy, cx, cy = (K[:, i, None, None] for i in range(4))
    tw = torch.stack([a[..., 2], b[..., 2], xyz[..., 2]], -1)
    tu = fx * torch.stack([a[..., 0], b[..., 0], xyz[..., 0]], -1) + cx * tw
    tv = fy * torch.stack([a[..., 1], b[..., 1], xyz[..., 1]], -1) + cy * tw
    if dummy is not None:
        tu = tu + torch.nn.functional.pad(dummy[..., 0:1], (2, 0))
        tv = tv + torch.nn.functional.pad(dummy[..., 1:2], (2, 0))
    sgn = tw.new_tensor([1.0, 1.0, -1.0])
    den = torch.sum(sgn * tw * tw, -1, keepdim=True)
    f = sgn / torch.where(den.abs() < 1e-12, torch.ones_like(den), den)
    c = torch.stack([torch.sum(f * tu * tw, -1), torch.sum(f * tv * tw, -1)], -1)

    def root(v):
        pos = v > 0
        return torch.where(pos, torch.sqrt(torch.where(pos, v, torch.ones_like(v))), 0.0)

    ext = torch.stack([root(c[..., 0] ** 2 - torch.sum(f * tu * tu, -1)),
                       root(c[..., 1] ** 2 - torch.sum(f * tv * tv, -1))], -1)
    radius = torch.ceil(3.0 * torch.clamp(ext.amax(-1), min=1.0 / math.sqrt(2.0)))
    valid = ((xyz[..., 2] > NEAR) & (den[..., 0].abs() >= 1e-12) & (cos[..., 0] != 0)
             & torch.isfinite(c).all(-1) & torch.isfinite(ext).all(-1)
             & (c.abs() < 1e7).all(-1) & (ext < 1e7).all(-1) & alive)
    return dict(tu=tu, tv=tv, tw=tw, normal=normal, centre=c, radius=radius,
                depth=xyz[..., 2], valid=valid)


def tile_box(centre, radius, valid, tiles, span):
    """Each surfel's box of tiles (x0, y0, nx, ny), clamped to ``span``
    tiles a side about its centre's tile, and whether it is non-empty."""
    out = []
    for ax in (0, 1):
        c = centre[..., ax]
        lo = torch.clamp(torch.floor((c - radius) / TILE), 0, tiles).long()
        hi = torch.clamp(torch.floor((c + radius + TILE - 1) / TILE), 0, tiles).long()
        n = hi - lo
        mid = torch.clamp((c / TILE).long(), 0, tiles - 1)
        first = torch.minimum(torch.maximum(mid - span // 2, lo), torch.maximum(hi - span, lo))
        out += [torch.where(n > span, first, lo), torch.clamp(n, max=span)]
    x0, nx, y0, ny = out
    return x0, y0, nx, ny, valid & (nx > 0) & (ny > 0)


def entries(proj: Dict, f: int, res: int, span_cap: int, entry_cap: int):
    """Frame f's (surfel, tile) entries in compositing order: (surfel
    ids, tiles), each (E,)."""
    tiles = -(-res // TILE)
    n_tiles = tiles * tiles
    centre, radius, valid = proj["centre"][f], proj["radius"][f], proj["valid"][f]
    p = valid.shape[0]
    dev = valid.device
    big_box = tile_box(centre, radius, valid, tiles, span_cap)
    small_box = tile_box(centre, radius, valid, tiles, SMALL_SPAN)
    big = big_box[4] & ((big_box[2] > SMALL_SPAN) | (big_box[3] > SMALL_SPAN))
    big = big & (torch.cumsum(big.long(), 0) <= min(p, max(32, p // 16)))

    def emit(box, keep, ids, span):
        x0, y0, nx, ny, ok = (v[ids] for v in box)
        j = torch.arange(span * span, device=dev)
        dx, dy = j % torch.clamp(nx, min=1)[:, None], j // torch.clamp(nx, min=1)[:, None]
        hit = (dy < ny[:, None]) & (ok & keep[ids])[:, None]
        tile = (y0[:, None] + dy) * tiles + x0[:, None] + dx
        return ids[:, None].expand_as(tile)[hit], tile[hit]

    all_ids = torch.arange(p, device=dev)
    s_ids, s_tiles = emit(small_box, ~big, all_ids, SMALL_SPAN)
    b_ids, b_tiles = emit(big_box, big, all_ids[big], span_cap)
    ids, tile = torch.cat([s_ids, b_ids]), torch.cat([s_tiles, b_tiles])
    bits = 30 - max(1, math.ceil(math.log2(max(n_tiles, 2))))
    code = (torch.clamp((proj["depth"][f].detach()[ids] - NEAR) / (FAR - NEAR), 0.0, 1.0)
            * ((1 << bits) - 1)).to(torch.int32).long()
    code = torch.clamp(code, max=(1 << bits) - 2)
    order = torch.sort(tile * (1 << bits) + code, stable=True).indices
    ids, tile = ids[order], tile[order]
    if entry_cap:
        # each tile's list starts on a CHUNK slot; slots past the cap are cut
        counts = torch.bincount(tile, minlength=n_tiles)
        padded = (counts + CHUNK - 1) // CHUNK * CHUNK
        start = torch.cumsum(padded, 0) - padded
        first = torch.cumsum(counts, 0) - counts
        slot = start[tile] + torch.arange(tile.shape[0], device=dev) - first[tile]
        keep = slot < -(-entry_cap // CHUNK) * CHUNK + n_tiles * CHUNK
        ids, tile = ids[keep], tile[keep]
    return ids, tile


def composite(proj: Dict, colour: torch.Tensor, opacity: torch.Tensor, bg: torch.Tensor,
              res: int, span_cap: int, entry_cap: int) -> Dict[str, torch.Tensor]:
    """Every frame's images (M, res, res, ...): colour (C channels, over the
    background bg), alpha, expected depth and normal."""
    m = proj["depth"].shape[0]
    tiles = -(-res // TILE)
    dev = opacity.device
    n_px = res * res
    lin = torch.arange(TILE * TILE, device=dev)
    out = {k: [] for k in ("colour", "alpha", "depth", "normal")}
    for f in range(m):
        ids, tile = entries(proj, f, res, span_cap, entry_cap)
        # (entry, pixel) pairs, entries in order; pixels outside the image dropped
        px = ((tile % tiles) * TILE)[:, None] + lin % TILE
        py = ((tile // tiles) * TILE)[:, None] + lin // TILE
        inside = (px < res) & (py < res)
        pid = (py * res + px)[inside]
        sid = ids[:, None].expand_as(px)[inside]
        x, y = px[inside].to(opacity.dtype) + 0.5, py[inside].to(opacity.dtype) + 0.5

        def response():
            s, xx, yy = sid, x, y
            tu, tv, tw = proj["tu"][f][s], proj["tv"][f][s], proj["tw"][f][s]
            k = xx[:, None] * tw - tu
            ll = yy[:, None] * tw - tv
            p = torch.linalg.cross(k, ll, dim=-1)
            pz = p[:, 2]
            ok = pz != 0.0
            pz = torch.where(ok, pz, torch.ones_like(pz))
            sx = torch.clamp(p[:, 0] / pz, -1e6, 1e6)
            sy = torch.clamp(p[:, 1] / pz, -1e6, 1e6)
            r3 = sx * sx + sy * sy
            c = proj["centre"][f][s]
            r2 = LOWPASS_INV2 * ((c[:, 0] - xx) ** 2 + (c[:, 1] - yy) ** 2)
            depth = torch.where(r3 <= r2, sx * tw[:, 0] + sy * tw[:, 1] + tw[:, 2], tw[:, 2])
            alpha = torch.clamp(opacity[s] * torch.exp(-0.5 * torch.minimum(r3, r2)),
                                max=ALPHA_MAX)
            return alpha, depth, ok & (depth >= NEAR) & (alpha >= ALPHA_MIN)

        with torch.no_grad():
            hit = response()[2]
        sid, pid, x, y = sid[hit], pid[hit], x[hit], y[hit]
        alpha, depth, _ = response()
        # each pixel's surfels in order: a stable sort by pixel keeps the entries' order
        order = torch.sort(pid, stable=True).indices
        sid, pid, alpha, depth = sid[order], pid[order], alpha[order], depth[order]
        log_t = torch.log1p(-alpha.double())
        run = torch.cumsum(log_t, 0)
        counts = torch.bincount(pid, minlength=n_px)
        before = (torch.cumsum(counts, 0) - counts)[pid]      # first pair of the pixel
        base = torch.where(before > 0, run[torch.clamp(before - 1, min=0)], 0.0)
        t_incl = torch.exp(run - base)
        t_prev = torch.exp(run - base - log_t)
        used = t_incl.detach() >= T_MIN
        w = (alpha.double() * t_prev * used).to(alpha.dtype)
        t_final = torch.exp(torch.zeros(n_px, dtype=torch.float64, device=dev)
                            .index_add(0, pid, log_t * used)).to(alpha.dtype)

        def gather(v):
            return torch.zeros((n_px,) + v.shape[1:], dtype=v.dtype, device=dev).index_add(
                0, pid, v * w.reshape((-1,) + (1,) * (v.dim() - 1)))

        col = gather(colour[f][sid]) + t_final[:, None] * bg
        img = lambda v: v.reshape((res, res) + v.shape[1:])
        out["colour"].append(img(col))
        out["alpha"].append(img(1.0 - t_final))
        out["depth"].append(img(gather(depth)))
        out["normal"].append(img(gather(proj["normal"][f][sid])))
    return {k: torch.stack(v) for k, v in out.items()}
