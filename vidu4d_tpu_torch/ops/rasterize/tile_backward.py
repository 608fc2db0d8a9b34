"""Backward tile compositor, its autograd wiring, and the batched
differentiable rasterizer of the training path
(`vidu4d_tpu/ops/rasterize/pallas_backward.py`).

`backward_tiles` is the analytic VJP of `tile_forward.forward_tiles`: the
hand-written CUDA kernel ``csrc/tile_backward.cu`` for CUDA tensors, its
plain PyTorch version `backward_tiles_plain` for CPU tensors.
`TileComposite` joins the two as one ``torch.autograd.Function`` (the JAX
package's ``_make_core`` custom VJP), and `rasterize_batch` is the frames-
folded-into-the-grid rasterizer (``rasterize_pallas_grad_batch``, without
the mesh branch): `prepare_batch` bins and packs, then `composite_batch`
makes one forward and one backward launch per step.
"""

from __future__ import annotations

import torch

from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.ops.rasterize import common
from vidu4d_tpu_torch.ops.rasterize.compositing import CompositeOutput
from vidu4d_tpu_torch.ops.rasterize.tile_forward import (
    CHUNK, CX, CY, EXTRA, NRM, OPAC, PA, PB, PC, QD, RGB, SLAB_WIDTH,
    TILE, TW2, _pixel_centers, check_tile, forward_tiles, ndc_depth, pack_props,
    splat_response, tile_library, work_list,
)


@torch.no_grad()
def backward_tiles_plain(slab, tile_start, tile_count, cot, resid,
                         tiles_x: int, tiles_per_frame: int, n_extra: int,
                         tile: int = TILE):
    """Plain PyTorch version of the backward kernel: CHUNK entries per step
    in reverse, T-before rebuilt by division with suffix products, suffix
    sums for the alpha gradient (the Pallas kernel's formulation).
    Returns the (E, 32) per-entry grad slab."""
    kernels.COUNTS["tile_backward_plain"] += 1
    grad = torch.zeros_like(slab)
    nt = tile_start.shape[0]
    if nt == 0:
        return grad
    dev = slab.device
    pxf, pyf = _pixel_centers(nt, tiles_x, tiles_per_frame, dev, tile)
    px3, py3 = pxf[:, None, :], pyf[:, None, :]
    t_fin, n_contrib, s1_tot, s2_tot = (x[:, None, :] for x in resid.unbind(-1))
    a_tot = 1.0 - t_fin
    g_c = cot[..., 0:3]
    g_d, g_a = cot[..., 3][:, None], cot[..., 4][:, None]
    g_n = cot[..., 5:8]
    g_bgdot, g_dist = cot[..., 8][:, None], cot[..., 9][:, None]
    g_x = cot[..., 10:]
    g_tfin = -g_a + g_bgdot

    count_eff = torch.minimum(
        tile_count, torch.ceil(torch.amax(resid[..., 1], dim=1)).to(torch.int32))
    max_count = int(count_eff.max())
    n_chunks = -(-max_count // CHUNK)
    t_after = resid[..., 0].clone()
    s_gw = torch.zeros_like(t_after)
    k = torch.arange(min(CHUNK, max_count), device=dev)  # shallow tiles: one short step
    for c in reversed(range(n_chunks)):
        rank = c * CHUNK + k
        valid = rank[None, :] < tile_count[:, None]
        idx = torch.clamp(tile_start[:, None].long() + rank[None, :], max=slab.shape[0] - 1)
        rows = slab[idx]
        r = splat_response(rows, px3, py3)
        clamped = r["alpha_raw"] > common.ALPHA_CLAMP
        alpha = torch.clamp(r["alpha_raw"], max=common.ALPHA_CLAMP)
        ok = (r["pz_ok"] & (r["depth"] >= common.NEAR_PLANE)
              & (alpha >= common.ALPHA_EPS) & valid[..., None]
              & (rank.float()[None, :, None] < n_contrib))
        alpha = torch.where(ok, alpha, 0.0)
        depth = torch.where(ok, r["depth"], 0.0)
        om = 1.0 - alpha
        sp_incl = torch.flip(torch.cumprod(torch.flip(om, [1]), 1), [1])
        t_before = t_after[:, None, :] / sp_incl
        w = alpha * t_before
        depth_pos = torch.clamp(depth, min=1e-6)
        m = ndc_depth(depth_pos)

        col = lambda ch: rows[..., ch:ch + 1]
        gw = (
            col(RGB) * g_c[:, None, :, 0] + col(RGB + 1) * g_c[:, None, :, 1]
            + col(RGB + 2) * g_c[:, None, :, 2]
            + depth * g_d
            + col(NRM) * g_n[:, None, :, 0] + col(NRM + 1) * g_n[:, None, :, 1]
            + col(NRM + 2) * g_n[:, None, :, 2]
            + g_dist * (m * m * a_tot + s2_tot - 2.0 * m * s1_tot)
        )
        for e in range(n_extra):
            gw = gw + col(EXTRA + e) * g_x[:, None, :, e]
        gww = gw * w
        suf = torch.flip(torch.cumsum(torch.flip(gww, [1]), 1), [1]) - gww \
            + s_gw[:, None, :]
        g_alpha = gw * t_before - (suf + g_tfin * t_fin) / torch.clamp(om, min=1e-3)
        g_alpha = torch.where(ok & ~clamped, g_alpha, 0.0)
        g_opac = g_alpha * r["g"]
        g_rho = g_alpha * col(OPAC) * r["g"] * (-0.5)
        g_m = g_dist * 2.0 * w * (m * a_tot - s1_tot)
        dmdd = torch.where(
            depth > 1e-6,
            (common.FAR_PLANE * common.NEAR_PLANE)
            / ((common.FAR_PLANE - common.NEAR_PLANE) * depth_pos * depth_pos),
            0.0,
        )
        g_depth = torch.where(ok, w * g_d + g_m * dmdd, 0.0)
        use3d = r["use3d"]
        ipz_g = torch.where(ok, r["ipz"], 0.0)
        ipz2_g = ipz_g * ipz_g
        rho3d_g = torch.where(ok, r["rho3d"], 0.0)
        g_rho3 = torch.where(use3d, g_rho, 0.0)
        # d rho2d / d cx = 2 FIS dx, summed pixel by pixel (no expansion)
        g_c2 = torch.where(use3d, 0.0, 2.0 * common.FILTER_INV_SQUARE * g_rho)
        g_d3 = torch.where(use3d, g_depth, 0.0)
        g_d2 = torch.where(use3d, 0.0, g_depth)
        g_px = 2.0 * r["px"] * ipz2_g * g_rho3
        g_py = 2.0 * r["py"] * ipz2_g * g_rho3
        g_pz = -(2.0 * rho3d_g * g_rho3 + depth * g_d3) * ipz_g
        g_q = ipz_g * g_d3

        def psum(x):
            return torch.sum(torch.where(ok, x, 0.0), dim=2)

        out = torch.zeros(rows.shape, device=dev)
        for ch, x in (
            (PA, g_px), (PA + 1, g_py), (PA + 2, g_pz),
            (PB, px3 * g_px), (PB + 1, px3 * g_py), (PB + 2, px3 * g_pz),
            (PC, py3 * g_px), (PC + 1, py3 * g_py), (PC + 2, py3 * g_pz),
            (QD, g_q), (TW2, g_d2), (CX, r["dx"] * g_c2), (CY, r["dy"] * g_c2),
            (OPAC, g_opac),
        ):
            out[..., ch] = psum(x)
        for i in range(3):
            out[..., RGB + i] = psum(w * g_c[:, None, :, i])
            out[..., NRM + i] = psum(w * g_n[:, None, :, i])
        for e in range(n_extra):
            out[..., EXTRA + e] = psum(w * g_x[:, None, :, e])
        grad[idx[valid]] = out[valid]
        t_after = t_before[:, 0, :]
        s_gw = s_gw + torch.sum(gww, dim=1)
    return grad


def effective_counts(tile_count, resid):
    """(T,) int32: each tile's entries up to its largest n_contrib, the
    only ones with a gradient."""
    n_max = torch.ceil(torch.amax(resid[..., 1], dim=1)).to(torch.int32)
    return torch.minimum(tile_count, n_max).contiguous()


def backward_tiles(slab, tile_start, tile_count, cot, resid, tiles_x: int,
                   tiles_per_frame: int, n_extra: int, tile: int = TILE):
    """Per-entry (E, 32) grad slab of the forward compositor.

    cot (T, tile^2, 10 + n_extra): gC(3) gD gA gN(3) gBGdot gDist gX;
    resid (T, tile^2, 4): T_fin, n_contrib, S1, S2 (aux[..., 8:12]).
    CPU tensors run the plain version; CUDA tensors launch the kernels (two
    passes over the work list of count_eff, each tile's entries up to its
    largest n_contrib), or this raises."""
    check_tile(tile)
    if slab.device.type == "cpu":
        return backward_tiles_plain(slab, tile_start, tile_count, cot, resid,
                                    tiles_x, tiles_per_frame, n_extra, tile)
    if slab.device.type != "cuda":
        raise ValueError(f"no tile_backward kernel for device {slab.device}")
    dev = slab.device
    nt = tile_start.shape[0]
    px_n = tile * tile
    kernels.check_tensor("slab", slab, dev)
    if slab.dim() != 2 or slab.shape[1] != SLAB_WIDTH:
        raise ValueError(f"slab must be (E, {SLAB_WIDTH}), got {tuple(slab.shape)}")
    kernels.check_tensor("tile_start", tile_start, dev, (nt,), torch.int32)
    kernels.check_tensor("tile_count", tile_count, dev, (nt,), torch.int32)
    kernels.check_tensor("cot", cot, dev, (nt, px_n, 10 + n_extra))
    kernels.check_tensor("resid", resid, dev, (nt, px_n, 4))
    lib = tile_library()
    count_eff = effective_counts(tile_count, resid)
    item_off, n_blocks = work_list(count_eff, slab.shape[0])
    pl = torch.empty((n_blocks, 2, px_n), dtype=torch.float32, device=dev)
    grad = torch.zeros_like(slab)
    rc = lib.vidu4d_tile_backward(
        slab.data_ptr(), tile_start.data_ptr(), count_eff.data_ptr(),
        item_off.data_ptr(), cot.data_ptr(), resid.data_ptr(), pl.data_ptr(),
        grad.data_ptr(), nt, n_blocks, tiles_x, tiles_per_frame, tile, n_extra,
        kernels.stream_ptr(dev),
    )
    kernels.check_launch(rc, "tile_backward")
    kernels.COUNTS["tile_backward"] += 1
    return grad


class TileComposite(torch.autograd.Function):
    """Forward kernel + analytic backward kernel (`pallas_backward.py:449`).

    Outputs color (T, tile^2, 3+X) and aux[..., :8]; aux[..., 8:12] (T_fin,
    n_contrib, S1, S2) are kept as the backward's residuals. The median
    depth / weight channels (5, 7) get no gradient."""

    @staticmethod
    def forward(ctx, slab, tile_start, tile_count, bg, tiles_x, tiles_per_frame,
                n_extra, tile):
        color, aux = forward_tiles(slab, tile_start, tile_count, bg, tiles_x,
                                   tiles_per_frame, n_extra, tile)
        ctx.save_for_backward(slab, tile_start, tile_count, bg,
                              aux[..., 8:12].contiguous())
        ctx.geom = (tiles_x, tiles_per_frame, n_extra, tile)
        return color, aux[..., :8]

    @staticmethod
    def backward(ctx, g_color, g_aux):
        slab, tile_start, tile_count, bg, resid = ctx.saved_tensors
        tiles_x, tiles_per_frame, n_extra, tile = ctx.geom
        g_bgdot = torch.sum(g_color * bg, dim=-1, keepdim=True)
        cot = torch.cat(
            [g_color[..., :3], g_aux[..., 0:1], g_aux[..., 1:2], g_aux[..., 2:5],
             g_bgdot, g_aux[..., 6:7], g_color[..., 3:]], dim=-1,
        ).contiguous()
        g_slab = backward_tiles(slab, tile_start, tile_count, cot, resid,
                                tiles_x, tiles_per_frame, n_extra, tile)
        g_bg = torch.einsum("tp,tpc->c", resid[..., 0], g_color)
        return g_slab, None, None, g_bg, None, None, None, None


def prepare_batch(proj_b: common.SplatProjection, colors_b: torch.Tensor,
                  opacities: torch.Tensor, bg_color: torch.Tensor, height: int,
                  width: int, span_cap: int = 4, entry_cap: int = 0,
                  tile: int = TILE) -> dict:
    """Bin and pack M frames into the kernels' inputs at tile side ``tile``:
    one slab with the frames' segments concatenated, tile tables offset
    into it (frame f's tiles are blocks [f*T, (f+1)*T)), and bg zero-padded
    to 3 + n_extra. ``valid`` (M,) counts the splats that project in each
    frame."""
    check_tile(tile)
    tiles_y, tiles_x = common.tile_grid_shape(height, width, tile)
    n_extra = colors_b.shape[-1] - 3
    slabs, starts, counts = [], [], []
    offset = 0
    for f in range(proj_b.depth.shape[0]):
        proj_f = common.SplatProjection(*[x[f] for x in proj_b])
        binning = common.bin_splats_aligned(
            proj_f, height, width, tile=tile, span_cap=span_cap, chunk=CHUNK,
            entry_cap=entry_cap)
        slab_f = pack_props(proj_f, colors_b[f], opacities,
                            binning.sorted_splat_ids)
        slabs.append(slab_f)
        starts.append(binning.tile_start + offset)
        counts.append(binning.tile_count)
        offset += slab_f.shape[0]
    nchan = 3 + n_extra
    bg = torch.cat([bg_color[:nchan],
                    bg_color.new_zeros(max(0, nchan - bg_color.shape[0]))])
    return dict(
        slab=torch.cat(slabs),
        tile_start=torch.cat(starts).to(torch.int32).contiguous(),
        tile_count=torch.cat(counts).to(torch.int32).contiguous(),
        bg=bg.contiguous(), tiles_x=tiles_x, tiles_y=tiles_y,
        tiles_per_frame=tiles_x * tiles_y, n_extra=n_extra, tile=tile,
        valid=proj_b.valid.sum(dim=-1),
    )


def composite_batch(b: dict, height: int, width: int) -> CompositeOutput:
    """Differentiable tile compositing of a `prepare_batch` result: one
    forward and one backward launch for all its frames. Returns a
    CompositeOutput with (M, H, W, ...) fields."""
    tiles_x, tiles_y, tile = b["tiles_x"], b["tiles_y"], b["tile"]
    m = b["tile_start"].shape[0] // b["tiles_per_frame"]
    color, aux = TileComposite.apply(b["slab"], b["tile_start"], b["tile_count"],
                                     b["bg"], tiles_x, b["tiles_per_frame"],
                                     b["n_extra"], tile)

    def assemble(x):
        feat = x.shape[2:]
        img = x.reshape((m, tiles_y, tiles_x, tile, tile) + feat)
        img = img.transpose(2, 3).reshape((m, tiles_y * tile, tiles_x * tile) + feat)
        return img[:, :height, :width]

    color = assemble(color)
    aux = assemble(aux)
    return CompositeOutput(
        color=color,
        depth=aux[..., 0],
        alpha=aux[..., 1],
        normal=aux[..., 2:5],
        median_depth=aux[..., 5].detach(),
        distortion=aux[..., 6],
        median_weight=aux[..., 7].detach(),
        final_t=1.0 - aux[..., 1],
    )


def rasterize_batch(proj_b: common.SplatProjection, colors_b: torch.Tensor,
                    opacities: torch.Tensor, bg_color: torch.Tensor,
                    height: int, width: int, span_cap: int = 4,
                    entry_cap: int = 0, tile: int = TILE) -> CompositeOutput:
    """Differentiable rasterization of M frames with the tile kernels
    (`pallas_backward.py:579`); the frame dim folds into the launch grid.

    proj_b: SplatProjection with (M, P, ...) fields; colors_b (M, P, C);
    opacities (P,); bg_color (C',) shared, zero-padded to C.
    Returns a CompositeOutput with (M, H, W, ...) fields."""
    b = prepare_batch(proj_b, colors_b, opacities, bg_color, height, width,
                      span_cap=span_cap, entry_cap=entry_cap, tile=tile)
    return composite_batch(b, height, width)
