"""TSDF fusion (`vidu4d_tpu/preprocess/tsdf.py`).

Depth maps are integrated into a fixed-resolution voxel grid, one frame at
a time on the device: each frame projects all G^3 voxels into its image and
gathers the depth there (the gather formulation; no scatter). Mesh
extraction uses marching tetrahedra; cameras are recentred as the
reference does (`tsdf_fusion.py:88-113`).
"""

from __future__ import annotations

import numpy as np
import torch

from vidu4d_tpu_torch.ops.marching import extract_mesh_np
from vidu4d_tpu_torch.preprocess.ops import bilinear_sample


def view_frustum_points(depth: torch.Tensor, kinv: torch.Tensor,
                        cam2scene: torch.Tensor) -> torch.Tensor:
    """Scene-space corners (8, 3) of the view frustum of depth (H, W)
    (`tsdf.py:23`)."""
    h, w = depth.shape
    dmax = torch.clamp(torch.max(depth), min=1e-3)
    corners = torch.tensor([[0.0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]],
                           dtype=depth.dtype, device=depth.device)
    ray = corners @ kinv.T
    pts = torch.cat([ray * 0.0, ray * dmax], dim=0)
    return pts @ cam2scene[:3, :3].T + cam2scene[:3, 3]


@torch.no_grad()
def fuse_tsdf(
    depths: torch.Tensor,  # (T, H, W) masked depth (0 = invalid)
    colors: torch.Tensor,  # (T, H, W, 3)
    kinvs: torch.Tensor,  # (T, 3, 3)
    cam2scene: torch.Tensor,  # (T, 4, 4)
    vol_bnds: torch.Tensor,  # (2, 3) scene-space bounds
    grid_size: int = 128,
    trunc_ratio: float = 5.0,
):
    """Integrate every frame (`tsdf.py:39`). Returns (tsdf (G, G, G),
    color (G, G, G, 3), weight (G, G, G)) on the inputs' device."""
    g = grid_size
    voxel_size = torch.max((vol_bnds[1] - vol_bnds[0]) / g)
    trunc = trunc_ratio * voxel_size
    axes = [torch.linspace(float(vol_bnds[0, i]), float(vol_bnds[1, i]), g,
                           device=depths.device) for i in range(3)]
    vox = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    tsdf = torch.ones(vox.shape[0], device=depths.device)
    color = torch.zeros((vox.shape[0], 3), device=depths.device)
    weight = torch.zeros(vox.shape[0], device=depths.device)
    h, w = depths.shape[1:]
    for depth, rgb, kinv, c2s in zip(depths, colors, kinvs, cam2scene):
        s2c = torch.linalg.inv(c2s)
        vox_cam = vox @ s2c[:3, :3].T + s2c[:3, 3]
        z = vox_cam[:, 2]
        kmat = torch.linalg.inv(kinv)
        zc = torch.clamp(z, min=1e-6)
        u = kmat[0, 0] * vox_cam[:, 0] / zc + kmat[0, 2]
        v = kmat[1, 1] * vox_cam[:, 1] / zc + kmat[1, 2]
        inside = (z > 0) & (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
        d_obs = bilinear_sample(depth[..., None], u, v)[:, 0]
        rgb_obs = bilinear_sample(rgb, u, v)
        sdf = d_obs - z
        valid = inside & (d_obs > 0) & (sdf >= -trunc)
        tsdf_obs = torch.clamp(sdf / trunc, -1.0, 1.0)
        obs_w = valid.to(torch.float32)
        new_weight = weight + obs_w
        denom = torch.clamp(new_weight, min=1e-6)
        tsdf = (tsdf * weight + tsdf_obs * obs_w) / denom
        color = (color * weight[:, None] + rgb_obs * obs_w[:, None]) / denom[:, None]
        weight = new_weight
    return tsdf.reshape(g, g, g), color.reshape(g, g, g, 3), weight.reshape(g, g, g)


def tsdf_to_mesh(tsdf: torch.Tensor, weight: torch.Tensor, vol_bnds: torch.Tensor):
    """The zero surface as numpy (verts (V, 3), faces (F, 3)); unobserved
    voxels are pushed outside (`tsdf.py:90`)."""
    sdf = torch.where(weight > 0, tsdf, torch.ones_like(tsdf))
    return extract_mesh_np(sdf, vol_bnds)


def recenter_mesh_and_cams(verts: np.ndarray, cams_scene2cam: np.ndarray):
    """Centre the mesh at the origin and shift the cameras accordingly
    (`tsdf.py:96`). Returns (verts_centered, cams_centered)."""
    center = 0.5 * (verts.min(0) + verts.max(0))
    verts = verts - center
    cams_out = []
    for s2c in cams_scene2cam:
        c2s = np.linalg.inv(s2c)
        c2s[:3, 3] -= center
        cams_out.append(np.linalg.inv(c2s))
    return verts, np.stack(cams_out)
