"""Rasterizer configuration and the single-camera differentiable rasterizer
(`vidu4d_tpu/ops/rasterize/api.py`).

`rasterize` is the JAX package's ``impl="pallas_grad"`` path: projection,
the one-sort binning and the slab pack, then the tile kernels (one forward
and one backward launch) through `tile_backward.composite_batch` with one
frame. The JAX ``xla_tiles`` / ``naive`` implementations are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vidu4d_tpu_torch.ops import sh as sh_ops
from vidu4d_tpu_torch.ops.rasterize import common
from vidu4d_tpu_torch.ops.rasterize.compositing import CompositeOutput
from vidu4d_tpu_torch.ops.rasterize.tile_backward import composite_batch, prepare_batch


class RasterizeConfig(NamedTuple):
    """The kernels' tile side is fixed at 16 (tile_forward.TILE)."""

    span_cap: int = 4  # max tiles per axis a splat may cover
    # static cap on the sorted entries packed per frame (0 = none); exact
    # while a frame's entry count stays under it (the JAX kernel path's
    # default, `gs4d_trainer.py:264`)
    entry_cap: int = 2 ** 19


# the JAX `RasterizeConfig()` of `rasterize` and the static trainer: no cap
UNCAPPED = RasterizeConfig(entry_cap=0)


def camera_center(viewmat: torch.Tensor) -> torch.Tensor:
    """World-space camera centre of a (4, 4) world-to-camera matrix."""
    rot = viewmat[:3, :3]
    return -rot.T @ viewmat[:3, 3]


def rasterize_with_projection(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    viewmat: torch.Tensor,
    intrins: torch.Tensor,
    height: int,
    width: int,
    colors: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    bg_color: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    densify_dummy: Optional[torch.Tensor] = None,
    config: RasterizeConfig = UNCAPPED,
):
    """`rasterize`, also returning the frame's `SplatProjection` with
    (P, ...) fields (the static trainer's densify statistics read it)."""
    if (colors is None) == (shs is None):
        raise ValueError("provide exactly one of colors / shs")
    if colors is None:
        colors = sh_ops.eval_sh_color(sh_degree, shs, means3d, camera_center(viewmat))
    if bg_color is None:
        bg_color = torch.zeros(colors.shape[-1], dtype=colors.dtype, device=colors.device)
    proj_b = common.project_splats(
        means3d[None], quats[None], scales, viewmat, intrins[None], mask=mask,
        densify_dummy=None if densify_dummy is None else densify_dummy[None])
    prepared = prepare_batch(proj_b, colors[None], opacities, bg_color, height, width,
                             span_cap=config.span_cap, entry_cap=config.entry_cap)
    out = composite_batch(prepared, height, width)
    proj = common.SplatProjection(*[x[0] for x in proj_b])
    return CompositeOutput(*[x[0] for x in out]), proj


def rasterize(
    means3d: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    viewmat: torch.Tensor,
    intrins: torch.Tensor,
    height: int,
    width: int,
    colors: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    bg_color: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    densify_dummy: Optional[torch.Tensor] = None,
    config: RasterizeConfig = UNCAPPED,
) -> CompositeOutput:
    """Differentiable 2D-Gaussian-surfel rasterization of one camera
    (`api.py:56`).

    means3d (P, 3) world-space centres; quats (P, 4) rotations (w, x, y,
    z); scales (P, 2) tangent standard deviations; opacities (P,) in
    [0, 1]; viewmat (4, 4) world-to-camera; intrins (4,) fx, fy, cx, cy;
    either colors (P, C) or shs (P, K, 3), evaluated at the view directions
    from the camera centre; mask (P,) bool alive mask; densify_dummy (P, 2)
    zeros whose gradient is the viewspace densification signal. The
    default config has no entry cap, as JAX's. Returns a CompositeOutput
    with (H, W, ...) fields."""
    return rasterize_with_projection(
        means3d, quats, scales, opacities, viewmat, intrins, height, width,
        colors=colors, shs=shs, sh_degree=sh_degree, bg_color=bg_color, mask=mask,
        densify_dummy=densify_dummy, config=config)[0]
