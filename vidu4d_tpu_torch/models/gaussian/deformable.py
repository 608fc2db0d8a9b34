"""Stage-3 dynamic Gaussian surfels: warp module + rendering
(`vidu4d_tpu/models/gaussian/deformable.py`).

Per-frame forward warp: canonical surfel (x, q_c) -> DQ skinning (q_w, t_w)
-> field2cam (q_f, t_f):  x_cam = q_f (q_w x + t_w) + t_f,  q_cam = q_f q_w q_c.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from vidu4d_tpu.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.mlp import flax_default_init_
from vidu4d_tpu_torch.models.fields.time_mlp import CameraMLP, IntrinsicsMLP
from vidu4d_tpu_torch.models.fields.warping import warp_module
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops import sh as sh_ops
from vidu4d_tpu_torch.ops.quaternion import quaternion_mul, quaternion_translation_apply
from vidu4d_tpu_torch.ops.rasterize import RasterizeConfig
from vidu4d_tpu_torch.ops.rasterize.common import project_splats
from vidu4d_tpu_torch.ops.rasterize.tile_backward import prepare_batch


class GaussianDeformer(nn.Module):
    """Warp + camera + intrinsics MLPs driving the surfel cloud."""

    def __init__(self, frame_info: FrameInfo, fg_motion: str = "bob",
                 learnable_bg: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.warp = warp_module(fg_motion, frame_info, device=device)
        self.camera_mlp = CameraMLP(frame_info, device=device)
        self.intrinsics = IntrinsicsMLP(frame_info, device=device)
        self.logscale = nn.Parameter(torch.full((1,), math.log(0.1), device=device))
        self.logsigma = nn.Parameter(torch.zeros(1, device=device))
        self.learnable_bg = learnable_bg
        if learnable_bg:
            self.bg_color = nn.Parameter(torch.zeros(3, device=device))
        if generator is not None:
            flax_default_init_(self, generator)

    def get_samples(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """Camera + articulation cache (`deformable.py:63`)."""
        frame_id = batch["frameid"]
        kmat = self.intrinsics(frame_id)
        t_art, rest_art = self.warp.articulation.vals_and_mean(frame_id)
        return {
            "field2cam": self.camera_mlp(frame_id),
            "frame_id": frame_id,
            "inst_id": batch["dataid"],
            "Kinv": geom.K2inv(kmat) @ geom.K2mat(batch["crop2raw"]),
            "hxy": batch["hxy"],
            "t_articulation": t_art,
            "rest_articulation": rest_art,
        }

    def warp_surfels(self, xyz: torch.Tensor, rotation: torch.Tensor,
                     samples: Dict):
        """Canonical surfels (P, 3), (P, 4) -> camera space at each batch
        frame: xyz_cam (M, P, 3), rot_cam (M, P, 4), aux dict of (M, P, 1)."""
        m = samples["frame_id"].shape[0]
        p = xyz.shape[0]
        xyz_b = xyz[None, :, None, :].expand(m, p, 1, 3)
        (q_w, t_w), aux = self.warp(xyz_b, samples["frame_id"], samples["inst_id"],
                                    samples_dict=samples)
        q_w, t_w = q_w[:, :, 0], t_w[:, :, 0]
        xyz_t = quaternion_translation_apply(q_w, t_w, xyz_b[:, :, 0])
        rot_t = quaternion_mul(q_w, rotation[None])
        q_f, t_f = samples["field2cam"]
        xyz_cam = quaternion_translation_apply(q_f[:, None], t_f[:, None], xyz_t)
        rot_cam = quaternion_mul(q_f[:, None], rot_t)
        return xyz_cam, rot_cam, {k: v[:, :, 0] for k, v in aux.items()}

    def background(self) -> torch.Tensor:
        if self.learnable_bg:
            return torch.sigmoid(self.bg_color)
        return torch.zeros(3, device=self.logscale.device)


def prepare_surfels_batch(
    params: sf.SurfelParams,
    alive: torch.Tensor,
    xyz_cam: torch.Tensor,  # (M, P, 3)
    rot_cam: torch.Tensor,  # (M, P, 4)
    intrins: torch.Tensor,  # (M, 4)
    height: int,
    width: int,
    sh_degree: int,
    bg_color: torch.Tensor,  # (3,)
    config: RasterizeConfig,
    densify_dummy: Optional[torch.Tensor] = None,  # (M, P, 2)
) -> dict:
    """The tile kernels' inputs for the warped surfels of every batch frame
    (the JAX package's "pallas_grad" path of `render_surfels_batch`,
    `deformable.py:292-321`): SH colour at camera-space view dirs (camera
    at the origin), projection, binning and packing. `composite_batch` of
    the result renders the frames."""
    eye = torch.eye(4, dtype=xyz_cam.dtype, device=xyz_cam.device)
    colors = sh_ops.eval_sh_color(sh_degree, sf.get_features(params)[None], xyz_cam,
                                  torch.zeros(3, dtype=xyz_cam.dtype, device=xyz_cam.device))
    proj_b = project_splats(xyz_cam, rot_cam, sf.get_scaling(params), eye, intrins,
                            mask=alive, densify_dummy=densify_dummy)
    return prepare_batch(
        proj_b, colors, sf.get_opacity(params)[:, 0], bg_color, height, width,
        span_cap=config.span_cap, entry_cap=config.entry_cap,
    )
