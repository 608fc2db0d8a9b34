"""Rasterizer configuration (`vidu4d_tpu/ops/rasterize/api.py`)."""

from __future__ import annotations

from typing import NamedTuple


class RasterizeConfig(NamedTuple):
    """The kernels' tile side is fixed at 16 (tile_forward.TILE)."""

    span_cap: int = 4  # max tiles per axis a splat may cover
    # static cap on the sorted entries packed per frame (0 = none); exact
    # while a frame's entry count stays under it (the JAX kernel path's
    # default, `gs4d_trainer.py:264`)
    entry_cap: int = 2 ** 19
