"""Mesh extraction from trained surfels (`vidu4d_tpu/models/gaussian/extract.py`,
the reference's `gs/utils/mesh_utils.py` GaussianExtractor): render depth
and alpha over the training cameras with the forward tile kernel, fuse the
masked depth maps into a TSDF on the device, extract with marching
tetrahedra, write an OBJ."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.ops.marching import save_obj
from vidu4d_tpu_torch.ops.rasterize.api import UNCAPPED, RasterizeConfig, rasterize
from vidu4d_tpu_torch.preprocess.tsdf import fuse_tsdf, tsdf_to_mesh


@torch.no_grad()
def render_depth_maps(params: sf.SurfelParams, alive: torch.Tensor, cameras,
                      height: int, width: int, config: RasterizeConfig = UNCAPPED,
                      sh_degree: int = 3):
    """Per-camera (depth (M, H, W), alpha (M, H, W)) tensors on the surfels'
    device (`extract.py:20`). ``cameras`` have numpy ``viewmat`` and
    ``intrins`` (scene-reader cameras)."""
    dev = params.xyz.device
    depths, alphas = [], []
    for cam in cameras:
        out = rasterize(
            params.xyz, sf.get_rotation(params), sf.get_scaling(params),
            sf.get_opacity(params)[:, 0],
            torch.as_tensor(np.asarray(cam.viewmat, np.float32), device=dev),
            torch.as_tensor(np.asarray(cam.intrins, np.float32), device=dev),
            height, width, shs=sf.get_features(params), sh_degree=sh_degree,
            mask=alive, config=config,
        )
        depths.append(out.depth / torch.clamp(out.alpha, min=1e-6))
        alphas.append(out.alpha)
    return torch.stack(depths), torch.stack(alphas)


def extract_mesh(params: sf.SurfelParams, alive: torch.Tensor, cameras, height: int,
                 width: int, grid_size: int = 128, alpha_thresh: float = 0.5,
                 depth_trunc: float = 10.0, config: RasterizeConfig = UNCAPPED,
                 sh_degree: int = 3, out_path: Optional[str] = None):
    """TSDF-fused mesh over the camera set (`extract.py:41`; the reference's
    `mesh_utils.py:64-270`). Returns (verts, faces) numpy; writes an OBJ to
    ``out_path`` when the mesh is not empty."""
    dev = params.xyz.device
    depths, alphas = render_depth_maps(params, alive, cameras, height, width,
                                       config=config, sh_degree=sh_degree)
    depths = torch.where((alphas > alpha_thresh) & (depths < depth_trunc), depths, 0.0)
    kinvs = np.stack([
        np.linalg.inv(np.array([
            [c.intrins[0], 0, c.intrins[2]],
            [0, c.intrins[1], c.intrins[3]],
            [0, 0, 1],
        ], np.float32)) for c in cameras
    ])
    cam2scene = np.stack([np.linalg.inv(c.viewmat) for c in cameras])

    # volume bounds: the camera centres padded by the largest depth
    centers = cam2scene[:, :3, 3]
    radius = max(float(torch.abs(depths).max()), 1e-3)
    vol_bnds = np.stack([centers.min(0) - radius, centers.max(0) + radius]).astype(np.float32)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    colors = torch.zeros(depths.shape + (3,), device=dev)
    tsdf, _, weight = fuse_tsdf(depths, colors, t(kinvs), t(cam2scene), t(vol_bnds),
                                grid_size=grid_size)
    verts, faces = tsdf_to_mesh(tsdf, weight, t(vol_bnds))
    if out_path and len(verts):
        save_obj(out_path, verts, faces)
    return verts, faces
