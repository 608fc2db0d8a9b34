"""2DGS surfel rasterizer: projection, binning, and the tile kernels."""

from vidu4d_tpu_torch.ops.rasterize.api import RasterizeConfig
from vidu4d_tpu_torch.ops.rasterize.compositing import CompositeOutput
from vidu4d_tpu_torch.ops.rasterize.tile_backward import rasterize_batch

__all__ = ["CompositeOutput", "RasterizeConfig", "rasterize_batch"]
