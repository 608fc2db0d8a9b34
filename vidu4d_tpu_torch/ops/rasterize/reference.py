"""Naive O(P*H*W) rasterizer oracle (`vidu4d_tpu/ops/rasterize/reference.py`).

Test-only: composites every splat at every pixel in a global stable depth
order, restricted to the pixels of the splat's (clamped) tile rect, with the
direct cross-product response. Differentiable by autograd.
"""

from __future__ import annotations

import math

import torch

from vidu4d_tpu_torch.ops.rasterize import common
from vidu4d_tpu_torch.ops.rasterize.compositing import (
    CompositeOutput,
    composite,
    splat_pixel_response,
)


def rasterize_naive_from_projection(proj, colors, opacities, bg_color,
                                    height: int, width: int, tile: int = 16,
                                    span_cap: int = 4,
                                    pixel_chunk: int = 0,
                                    rects=None) -> CompositeOutput:
    """pixel_chunk > 0 evaluates the pixels that many at a time, which
    bounds the (splats, pixels) intermediates; each pixel composites on its
    own, so the result is the same. ``rects`` (`common.compute_tile_rects`
    of another projection of the same splats, such as the float32 one that
    a kernel binned) replaces the tile rects of ``proj``'s own."""
    tiles_y, tiles_x = common.tile_grid_shape(height, width, tile)
    num_tiles = tiles_x * tiles_y
    depth_bits = 30 - max(1, math.ceil(math.log2(max(num_tiles, 2))))
    order = torch.sort(common.quantize_depth(proj.depth, depth_bits),
                       stable=True).indices
    if rects is None:
        rects = common.compute_tile_rects(proj, height, width, tile, span_cap)
    g = lambda x: x[order]

    dev = proj.tu.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5], dim=-1).reshape(-1, 2).to(proj.tu.dtype)
    ptx = (xs // tile).reshape(-1)
    pty = (ys // tile).reshape(-1)

    splat = [g(x)[:, None] for x in (proj.tu, proj.tv, proj.tw, proj.center2d, opacities)]
    min_x, min_y = g(rects.min_x)[:, None], g(rects.min_y)[:, None]
    step = pixel_chunk or height * width
    parts = []
    for s in range(0, height * width, step):
        tx, ty = ptx[None, s:s + step], pty[None, s:s + step]
        alpha, depth = splat_pixel_response(*splat, pix[None, s:s + step, :])
        in_rect = (
            (tx >= min_x) & (tx < min_x + g(rects.span_x)[:, None])
            & (ty >= min_y) & (ty < min_y + g(rects.span_y)[:, None])
            & g(rects.valid)[:, None]
        )
        alpha = torch.where(in_rect, alpha, torch.zeros_like(alpha))
        parts.append(composite(alpha, depth, g(colors)[:, None, :],
                               g(proj.normal)[:, None, :], bg_color))
    return CompositeOutput(*[torch.cat(f).reshape((height, width) + f[0].shape[1:])
                             for f in zip(*parts)])
