"""Property slab + forward tile compositor
(`vidu4d_tpu/ops/rasterize/pallas_kernel.py`).

`pack_props` gathers per-splat properties into an entry-major ``(E, 32)``
slab, one row per depth-sorted tile entry (the row layout of the JAX
package: the two-plane intersection in affine-coefficient form, so that the
per (entry, pixel) work is ~2 FMAs per component; but the 2D low-pass term
reads the splat's projected centre and is evaluated in splat-centred
coordinates, as `compositing.py` does, not as the Pallas kernel's
polynomial in absolute pixel coordinates, whose float32 terms cancel).
`forward_tiles` runs the forward compositor over every (frame, tile): the
hand-written CUDA kernels of ``csrc/tile_forward.cu`` for tensors on a CUDA
device, its plain PyTorch version `forward_tiles_plain` for tensors on the
CPU. There is no fallback from one to the other.

The tile side is an argument of the compositor and its plain version, as
JAX's `RasterizeConfig.tile` (`TILE_SIDES`: the kernels are instantiated
for 8, 16 and 32; `check_tile` raises for any other side before a launch). The kernels
split every tile's entry list into work items of at most `SEG` entries, one
block per item; `work_list` builds the item table on the device (no host
synchronisation) and `decode_items` is its plain reading.
"""

from __future__ import annotations

import functools

import torch

from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.ops.rasterize import common

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
MAX_EXTRA = SLAB_WIDTH - EXTRA
CHUNK = 128  # tile segments start on CHUNK boundaries (bin_splats_aligned)
TILE = 16    # the default tile side (JAX's `RasterizeConfig.tile`)
TILE_SIDES = (8, 16, 32)  # the sides the kernels are instantiated for (kTileSides)
N_AUX = 12   # aux channels, see csrc/tile_forward.cu
SEG = 256    # entries per work item of the tile kernels (kSeg, csrc/tile_common.cuh)
N_PART_FIXED = 11  # per-item partial channels besides colour (csrc/tile_forward.cu)


def check_tile(tile: int) -> None:
    """Raise NotImplementedError unless the tile kernels take ``tile``."""
    if tile not in TILE_SIDES:
        raise NotImplementedError(
            f"tile side {tile}: the tile kernels take {', '.join(map(str, TILE_SIDES))}")


@functools.lru_cache(maxsize=None)
def tile_library():
    """The kernel library, once its item size, partial channels and tile
    sides are checked against SEG, N_PART_FIXED and TILE_SIDES, with which
    the wrappers size the work list and the partials buffer and check the
    side."""
    lib = kernels.library()
    got = (lib.vidu4d_tile_seg(), lib.vidu4d_tile_part_fixed(),
           tuple(lib.vidu4d_tile_side(i) for i in range(lib.vidu4d_tile_side_count())))
    if got != (SEG, N_PART_FIXED, TILE_SIDES):
        raise RuntimeError(f"the kernels' (item size, partial channels, tile sides) {got} "
                           f"are not {(SEG, N_PART_FIXED, TILE_SIDES)}")
    return lib


def work_list(counts: torch.Tensor, n_rows: int, seg: int = SEG):
    """The tile kernels' work list over (T,) int32 entry counts.

    Tile t owns items [item_off[t], item_off[t+1]); its item s covers
    entries [s*seg, min((s+1)*seg, count)). Returns item_off (T+1,) int32,
    an exclusive cumsum computed on counts' device, and the host-known
    grid size T + ceil(n_rows / seg), which bounds the item count because
    the tiles' segments are disjoint inside a slab of n_rows rows."""
    nt = counts.shape[0]
    items = torch.div(counts + (seg - 1), seg, rounding_mode="floor")
    item_off = torch.zeros(nt + 1, dtype=torch.int32, device=counts.device)
    item_off[1:] = torch.cumsum(items, 0)
    return item_off, nt + -(-n_rows // seg)


def decode_items(item_off: torch.Tensor, counts: torch.Tensor, seg: int = SEG):
    """Per item of a work list: (tile, first entry, entry count), each
    (N,), as the kernels find them (the largest t with item_off[t] <= item)."""
    item = torch.arange(int(item_off[-1]), device=item_off.device)
    tile = torch.searchsorted(item_off, item, right=True) - 1
    first = (item - item_off[tile]) * seg
    return tile, first, torch.clamp(counts[tile] - first, max=seg)


class _RowGather(torch.autograd.Function):
    """props (P, 32) -> rows (E, 32) whose backward scatter-adds only the
    first ``n_used`` columns (the backward kernel writes no other column,
    so the rest of the cotangent is zero: `pallas_kernel.py:369-409`)."""

    @staticmethod
    def forward(ctx, props, ids, n_used):
        ctx.save_for_backward(ids)
        ctx.n_props = props.shape[0]
        ctx.n_used = n_used
        return props[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n = ctx.n_used
        narrow = torch.zeros((ctx.n_props, n), dtype=g.dtype, device=g.device)
        narrow.index_add_(0, ids, g[:, :n])
        rest = torch.zeros((ctx.n_props, g.shape[1] - n), dtype=g.dtype,
                           device=g.device)
        return torch.cat([narrow, rest], dim=1), None, None


def pack_props(proj: common.SplatProjection, colors: torch.Tensor,
               opacities: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """One frame's per-splat properties gathered into the (E, 32) slab.

    The affine coefficients are computed once per splat here; gradients to
    Tu/Tv/Tw/center2d flow back through these lines by autograd."""
    p = proj.tu.shape[0]
    n_extra = colors.shape[-1] - 3
    if n_extra > MAX_EXTRA:
        raise ValueError(
            f"the tile kernels support at most {MAX_EXTRA} extra channels "
            f"(got {n_extra})"
        )
    tu, tv, tw = proj.tu, proj.tv, proj.tw
    a = torch.linalg.cross(tu, tv, dim=-1)
    b = torch.linalg.cross(tv, tw, dim=-1)
    c = torch.linalg.cross(tw, tu, dim=-1)
    q = torch.sum(a * tw, dim=-1, keepdim=True)
    zeros = lambda k: torch.zeros((p, k), dtype=tu.dtype, device=tu.device)
    props = torch.cat(
        [
            a, b, c, q, tw[:, 2:3], proj.center2d, zeros(1),
            opacities[:, None], colors[:, :3], proj.normal, colors[:, 3:],
            zeros(SLAB_WIDTH - EXTRA - n_extra),
        ],
        dim=-1,
    )
    return _RowGather.apply(props, sorted_ids, EXTRA + n_extra)


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
    csrc/tile_common.cuh. Returns a dict of (T, K, tile^2) tensors; dx, dy
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
    rho2d = common.FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, r(QD) * ipz, r(TW2).expand_as(rho3d))
    g = torch.exp(-0.5 * rho)
    return dict(px=px_, py=py_, pz_ok=pz_ok, ipz=ipz, rho3d=rho3d, dx=dx, dy=dy,
                use3d=use3d, depth=depth, g=g, alpha_raw=r(OPAC) * g)


def ndc_depth(depth_pos):
    f, n = common.FAR_PLANE, common.NEAR_PLANE
    return (f * depth_pos - f * n) / ((f - n) * depth_pos)


@torch.no_grad()
def forward_tiles_plain(slab, tile_start, tile_count, bg, tiles_x: int,
                        tiles_per_frame: int, n_extra: int, tile: int = TILE):
    """Plain PyTorch version of the forward kernel: every tile at once,
    CHUNK entries per step, front to back with prefix products (the Pallas
    kernel's formulation). Returns color (T, tile^2, 3+X), aux (T, tile^2,
    12)."""
    kernels.COUNTS["tile_forward_plain"] += 1
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
        alpha = torch.clamp(r["alpha_raw"], max=common.ALPHA_CLAMP)
        ok = (r["pz_ok"] & (r["depth"] >= common.NEAR_PLANE)
              & (alpha >= common.ALPHA_EPS) & valid[..., None])
        alpha = torch.where(ok, alpha, 0.0)
        depth = torch.where(ok, r["depth"], 0.0)
        cp = torch.cumprod(1.0 - alpha, dim=1)
        t_incl = t_c[:, None, :] * cp
        include = t_incl >= common.T_EARLY_STOP
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


def forward_tiles(slab, tile_start, tile_count, bg, tiles_x: int,
                  tiles_per_frame: int, n_extra: int, tile: int = TILE):
    """Forward compositor over T = tile_start.shape[0] (frame, tile) blocks
    of tile x tile pixels.

    slab (E, 32) f32; tile_start / tile_count (T,) int32, segments inside
    the slab; bg (3 + n_extra,) f32. Returns color (T, tile^2, 3 + n_extra)
    and aux (T, tile^2, 12). CPU tensors run the plain version; CUDA tensors
    launch the kernels (three passes over the work list), or this raises."""
    check_tile(tile)
    if slab.device.type == "cpu":
        return forward_tiles_plain(slab, tile_start, tile_count, bg, tiles_x,
                                   tiles_per_frame, n_extra, tile)
    if slab.device.type != "cuda":
        raise ValueError(f"no tile_forward kernel for device {slab.device}")
    dev = slab.device
    nt = tile_start.shape[0]
    nchan = 3 + n_extra
    if not 0 <= n_extra <= MAX_EXTRA:
        raise ValueError(f"n_extra must be in [0, {MAX_EXTRA}], got {n_extra}")
    kernels.check_tensor("slab", slab, dev)
    if slab.dim() != 2 or slab.shape[1] != SLAB_WIDTH:
        raise ValueError(f"slab must be (E, {SLAB_WIDTH}), got {tuple(slab.shape)}")
    kernels.check_tensor("tile_start", tile_start, dev, (nt,), torch.int32)
    kernels.check_tensor("tile_count", tile_count, dev, (nt,), torch.int32)
    kernels.check_tensor("bg", bg, dev, (nchan,))
    lib = tile_library()
    item_off, n_blocks = work_list(tile_count, slab.shape[0])
    px_n = tile * tile
    color = torch.empty((nt, px_n, nchan), dtype=torch.float32, device=dev)
    aux = torch.empty((nt, px_n, N_AUX), dtype=torch.float32, device=dev)
    trans = torch.empty((n_blocks, px_n), dtype=torch.float32, device=dev)
    part = torch.empty((n_blocks, N_PART_FIXED + nchan, px_n), dtype=torch.float32,
                       device=dev)
    rc = lib.vidu4d_tile_forward(
        slab.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        item_off.data_ptr(), bg.data_ptr(), trans.data_ptr(), part.data_ptr(),
        color.data_ptr(), aux.data_ptr(), nt, n_blocks, tiles_x, tiles_per_frame,
        tile, n_extra, kernels.stream_ptr(dev),
    )
    kernels.check_launch(rc, "tile_forward")
    kernels.COUNTS["tile_forward"] += 1
    return color, aux
