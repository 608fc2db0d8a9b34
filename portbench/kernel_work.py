"""The forward tile compositor's plain version on the tile kernels' own
inputs (the (E, 32) slab of depth-sorted entries and each tile's segment),
which the roofline readers need to count the (entry, pixel) pairs a call
must visit, composite and differentiate. Frozen from
``vidu4d_tpu_torch/ops/rasterize/tile_forward.py`` (``forward_tiles_plain``,
``splat_response``, ``_pixel_centers``, ``ndc_depth``) and
``tile_backward.py`` (``effective_counts``) at commit 1fb37daff6a2: they
read the slab's layout, which the kernels' entry points take; nothing here
is imported from the program."""

from __future__ import annotations

import torch

FILTER_INV_SQUARE = 2.0
NEAR_PLANE, FAR_PLANE = 0.2, 100.0
ALPHA_EPS, ALPHA_CLAMP, T_EARLY_STOP = 1.0 / 255.0, 0.99, 1e-4
TILE = 16
CHUNK = 128
# slab columns (pallas_kernel.py:60-73); 21 + n_extra of the 32 are used
SLAB_WIDTH = 32
PA, PB, PC = 0, 3, 6  # A = Tu x Tv, B = Tv x Tw, C = Tw x Tu (3 each)
QD = 9      # q = det(Tu, Tv, Tw): 3D-branch depth numerator
TW2 = 10    # Tw.z: 2D-branch depth
CX, CY = 11, 12  # projected centre: rho2d = FIS*((cx-px)^2 + (cy-py)^2); 13 is spare
OPAC = 14
RGB = 15
NRM = 18
EXTRA = 21


def _pixel_centers(num_tiles: int, tiles_x: int, tiles_per_frame: int,
                   device, tile: int = TILE) -> tuple:
    """(T, tile^2) absolute pixel-centre coordinates of every tile's
    pixels (row-major in the tile)."""
    tl = torch.arange(num_tiles, device=device) % tiles_per_frame
    lin = torch.arange(tile * tile, device=device)
    pxf = ((tl % tiles_x) * tile)[:, None] + (lin % tile)[None, :]
    pyf = ((tl // tiles_x) * tile)[:, None] + (lin // tile)[None, :]
    return pxf.float() + 0.5, pyf.float() + 0.5


def splat_response(rows, pxf, pyf):
    """Per (entry, pixel) response from (T, K, 32) rows and (T, 1, tile^2)
    pixel centres: the plain versions' copy of ``splat_response`` in
    csrc/tile_cuh. Returns a dict of (T, K, tile^2) tensors; dx, dy
    are the splat-centred offsets cx - px, cy - py of the 2D branch."""
    r = lambda i: rows[..., i:i + 1]
    px_ = r(PA) + pxf * r(PB) + pyf * r(PC)
    py_ = r(PA + 1) + pxf * r(PB + 1) + pyf * r(PC + 1)
    pz_ = r(PA + 2) + pxf * r(PB + 2) + pyf * r(PC + 2)
    pz_ok = pz_ != 0.0
    ipz = 1.0 / torch.where(pz_ok, pz_, torch.ones_like(pz_))
    rho3d = (px_ * px_ + py_ * py_) * (ipz * ipz)
    dx = r(CX) - pxf
    dy = r(CY) - pyf
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, r(QD) * ipz, r(TW2).expand_as(rho3d))
    g = torch.exp(-0.5 * rho)
    return dict(px=px_, py=py_, pz_ok=pz_ok, ipz=ipz, rho3d=rho3d, dx=dx, dy=dy,
                use3d=use3d, depth=depth, g=g, alpha_raw=r(OPAC) * g)


def ndc_depth(depth_pos):
    f, n = FAR_PLANE, NEAR_PLANE
    return (f * depth_pos - f * n) / ((f - n) * depth_pos)


@torch.no_grad()
def forward_tiles_plain(slab, tile_start, tile_count, bg, tiles_x: int,
                        tiles_per_frame: int, n_extra: int, tile: int = TILE):
    """Plain PyTorch version of the forward kernel: every tile at once,
    CHUNK entries per step, front to back with prefix products (the Pallas
    kernel's formulation). Returns color (T, tile^2, 3+X), aux (T, tile^2,
    12)."""
    nt = tile_start.shape[0]
    dev = slab.device
    nchan = 3 + n_extra
    px_n = tile * tile
    pxf, pyf = _pixel_centers(nt, tiles_x, tiles_per_frame, dev, tile)
    pxf, pyf = pxf[:, None, :], pyf[:, None, :]
    zeros = torch.zeros((nt, px_n), device=dev)
    t_c, t_last = zeros + 1.0, zeros + 1.0
    col = torch.zeros((nt, px_n, nchan), device=dev)
    d_acc, s1, s2, med_d, med_w, ncon = (zeros.clone() for _ in range(6))
    nrm = torch.zeros((nt, px_n, 3), device=dev)
    chan = torch.tensor(list(range(RGB, RGB + 3)) + list(range(EXTRA, EXTRA + n_extra)),
                        device=dev)
    max_count = int(tile_count.max()) if nt else 0
    k = torch.arange(min(CHUNK, max_count), device=dev)  # shallow tiles: one short step
    for base in range(0, max_count, CHUNK):
        rank = base + k
        valid = rank[None, :] < tile_count[:, None]
        idx = torch.clamp(tile_start[:, None].long() + rank[None, :], max=slab.shape[0] - 1)
        rows = slab[idx]  # (T, K, 32)
        r = splat_response(rows, pxf, pyf)
        alpha = torch.clamp(r["alpha_raw"], max=ALPHA_CLAMP)
        ok = (r["pz_ok"] & (r["depth"] >= NEAR_PLANE)
              & (alpha >= ALPHA_EPS) & valid[..., None])
        alpha = torch.where(ok, alpha, 0.0)
        depth = torch.where(ok, r["depth"], 0.0)
        cp = torch.cumprod(1.0 - alpha, dim=1)
        t_incl = t_c[:, None, :] * cp
        include = t_incl >= T_EARLY_STOP
        t_prefix = t_c[:, None, :] * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)
        w = alpha * t_prefix * include
        col = col + torch.einsum("tkp,tkc->tpc", w, rows[..., chan])
        nrm = nrm + torch.einsum("tkp,tkc->tpc", w, rows[..., NRM:NRM + 3])
        d_acc = d_acc + torch.sum(w * depth, 1)
        m = ndc_depth(torch.clamp(depth, min=1e-6))
        s1 = s1 + torch.sum(w * m, 1)
        s2 = s2 + torch.sum(w * m * m, 1)
        cand = (w > 0) & (t_prefix > 0.5)
        last = torch.amax(torch.where(cand, k[None, :, None], -1), dim=1)
        has = last >= 0
        sel = torch.clamp(last, min=0)[:, None, :]
        med_d = torch.where(has, torch.gather(depth, 1, sel)[:, 0], med_d)
        med_w = torch.where(has, torch.gather(w, 1, sel)[:, 0], med_w)
        t_c = t_c * cp[:, -1]
        t_last = torch.amin(torch.where(include, t_incl, t_last[:, None, :]), dim=1)
        ncon = torch.maximum(
            ncon, torch.amax(torch.where(w > 0, (rank + 1.0)[None, :, None], 0.0), dim=1))
    color = col + t_last[..., None] * bg[:nchan]
    distort = s2 * (1.0 - t_last) - s1 * s1
    aux = torch.stack([d_acc, 1.0 - t_last, nrm[..., 0], nrm[..., 1], nrm[..., 2],
                       med_d, distort, med_w, t_last, ncon, s1, s2], dim=-1)
    return color, aux


def effective_counts(tile_count, resid):
    """(T,) int32: each tile's entries up to its largest n_contrib, the
    only ones with a gradient."""
    n_max = torch.ceil(torch.amax(resid[..., 1], dim=1)).to(torch.int32)
    return torch.minimum(tile_count, n_max).contiguous()
