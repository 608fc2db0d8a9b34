"""Stage-3 dynamic Gaussian surfels: warp module, warp losses + rendering
inputs (`vidu4d_tpu/models/gaussian/deformable.py`).

Per-frame forward warp: canonical surfel (x, q_c) -> DQ skinning (q_w, t_w)
-> field2cam (q_f, t_f):  x_cam = q_f (q_w x + t_w) + t_f,  q_cam = q_f q_w q_c.
The backward warp (frame -> canonical) feeds the cycle loss and the flow.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.dyn_nerf import flip_pair
from vidu4d_tpu_torch.models.fields.mlp import flax_default_init_
from vidu4d_tpu_torch.models.fields.skeleton import ArticulationSkelMLP
from vidu4d_tpu_torch.models.fields.time_mlp import CameraMLP, IntrinsicsMLP
from vidu4d_tpu_torch.models.fields.warping import SkinningWarp, warp_module
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops import sh as sh_ops
from vidu4d_tpu_torch.ops.numerics import safe_norm
from vidu4d_tpu_torch.ops.quaternion import (
    quaternion_mul,
    quaternion_translation_apply,
    quaternion_translation_inverse,
)
from vidu4d_tpu_torch.ops.rasterize import RasterizeConfig
from vidu4d_tpu_torch.ops.rasterize.common import project_splats
from vidu4d_tpu_torch.ops.rasterize.compositing import CompositeOutput
from vidu4d_tpu_torch.ops.rasterize.tile_backward import composite_batch, prepare_batch


class GaussianDeformer(nn.Module):
    """Warp + camera + intrinsics MLPs driving the surfel cloud."""

    def __init__(self, frame_info: FrameInfo, fg_motion: str = "bob", num_inst: int = 1,
                 learnable_bg: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # the instance count of the run (`deformable.py:47`); no module
        # reads it: the warps and MLPs condition on every video
        self.num_inst = num_inst
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
        """Camera + articulation cache (`deformable.py:63`). A batch
        "field2cam" (M, 7) (quaternion, translation) replaces the camera
        MLP's, its translation scaled by exp(logscale). A skinning warp
        caches its articulations: a batch "joint_so3" (M, B, 3) drives a
        skeleton's joints (the articulation of a bag of bones ignores it,
        as in JAX), and a batch "t_articulation" (M, B, 2, 4) (real, dual
        parts) replaces the articulation at the frames, over "joint_so3"
        too (reanimation, `deformable.py:86-103`). Other warps cache
        none."""
        frame_id = batch["frameid"]
        kmat = self.intrinsics(frame_id)
        if "field2cam" in batch:
            field2cam = (batch["field2cam"][..., :4],
                         batch["field2cam"][..., 4:] * torch.exp(self.logscale))
        else:
            field2cam = self.camera_mlp(frame_id)
        samples = {
            "field2cam": field2cam,
            "frame_id": frame_id,
            "inst_id": batch["dataid"],
            "Kinv": geom.K2inv(kmat) @ geom.K2mat(batch["crop2raw"]),
            "hxy": batch["hxy"],
        }
        if "feature" in batch:
            samples["feature"] = batch["feature"]
        if isinstance(self.warp, SkinningWarp):
            art = self.warp.articulation
            if "joint_so3" in batch and isinstance(art, ArticulationSkelMLP):
                t_art = art(frame_id, override_so3=batch["joint_so3"])
                rest = art.mean_vals()
                rest_art = (rest[0].expand_as(t_art[0]), rest[1].expand_as(t_art[1]))
            else:
                t_art, rest_art = art.vals_and_mean(frame_id)
            if "t_articulation" in batch:
                t_art = (batch["t_articulation"][..., 0, :],
                         batch["t_articulation"][..., 1, :])
            samples["t_articulation"] = t_art
            samples["rest_articulation"] = rest_art
        return samples

    def warp_surfels(self, xyz: torch.Tensor, rotation: torch.Tensor,
                     samples: Dict, no_warp: bool = False):
        """Canonical surfels (P, 3), (P, 4) -> camera space at each batch
        frame: xyz_cam (M, P, 3), rot_cam (M, P, 4), aux dict of (M, P, 1).
        no_warp: the canonical surfels, through the camera only (aux {})."""
        xyz_b = xyz[None].expand(samples["frame_id"].shape[0], *xyz.shape)
        if no_warp:
            xyz_t, rot_t, aux = xyz_b, rotation[None], {}
        else:
            (q_w, t_w), aux = self._warp_qt(xyz_b, samples)
            xyz_t = quaternion_translation_apply(q_w, t_w, xyz_b)
            rot_t = quaternion_mul(q_w, rotation[None])
        q_f, t_f = samples["field2cam"]
        xyz_cam = quaternion_translation_apply(q_f[:, None], t_f[:, None], xyz_t)
        rot_cam = quaternion_mul(q_f[:, None], rot_t)
        return xyz_cam, rot_cam, aux

    def _warp_qt(self, xyz: torch.Tensor, samples: Dict, backward: bool = False):
        """The warp's per-point rigid transform (q, t) for points (M, N, 3),
        each (M, N, 4/3), and its aux dict of (M, N, 1)."""
        (q, t), aux = self.warp(xyz[:, :, None], samples["frame_id"], samples["inst_id"],
                                samples_dict=samples, backward=backward, return_qt=True)
        return (q[:, :, 0], t[:, :, 0]), {k: v[:, :, 0] for k, v in aux.items()}

    def _canonicalize(self, xyz_cam: torch.Tensor, samples: Dict):
        """Camera points (M, N, 3) -> object space -> backward warp: the
        canonical points (M, N, 3) and the warp's aux dict."""
        q_i, t_i = quaternion_translation_inverse(*samples["field2cam"])
        xyz_obj = quaternion_translation_apply(q_i[:, None], t_i[:, None], xyz_cam)
        (q_b, t_b), aux = self._warp_qt(xyz_obj, samples, backward=True)
        return quaternion_translation_apply(q_b, t_b, xyz_obj), aux

    def cycle_loss(self, xyz_cam_t: torch.Tensor, xyz_canonical: torch.Tensor,
                   samples: Dict) -> Dict:
        """Backward-warp the warped surfels (M, N, 3) and take the L2
        distance to their canonical points (N, 3) (`deformable.py:147`).
        Returns {"cyc_dist", "xyz_cycled", "skin_entropy", "delta_skin"}."""
        xyz_cycled, aux = self._canonicalize(xyz_cam_t, samples)
        cyc_dist = safe_norm(xyz_cycled - xyz_canonical[None], dim=-1, keepdim=True)
        return {"cyc_dist": cyc_dist, "xyz_cycled": xyz_cycled, **aux}

    def flow_surfels(self, xyz_cam_t: torch.Tensor, samples: Dict,
                     xyz_cano: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Point-wise flow (M, P, 2): project the surfels at their frame and,
        warped through the canonical points, under the pair-flipped frame
        (`deformable.py:169`). xyz_cano (M, P, 3): the canonical points; if
        None they come from the backward warp of xyz_cam_t."""
        if xyz_cano is None:
            xyz_cano, _ = self._canonicalize(xyz_cam_t, samples)
        samples_next = dict(samples)
        for k in ("frame_id", "field2cam", "Kinv", "t_articulation",
                  "rest_articulation"):
            if k in samples:
                samples_next[k] = flip_pair(samples[k])
        (q_n, t_n), _ = self._warp_qt(xyz_cano, samples_next)
        xyz_t_next = quaternion_translation_apply(q_n, t_n, xyz_cano)
        q2, t2 = samples_next["field2cam"]
        xyz_cam_next = quaternion_translation_apply(q2[:, None], t2[:, None], xyz_t_next)
        xy0 = geom.pinhole_projection(geom.Kmatinv(samples["Kinv"]), xyz_cam_t)[..., :2]
        xy1 = geom.pinhole_projection(geom.Kmatinv(samples_next["Kinv"]),
                                      xyz_cam_next)[..., :2]
        return xy1 - xy0

    def global_match(self, feat_px: torch.Tensor, regist_feat: torch.Tensor,
                     xyz_canonical: torch.Tensor, num_candidates: int = 2048
                     ) -> torch.Tensor:
        """Soft match of pixel features (..., F) against a strided subset of
        the surfels' registration features (P, F): the expected canonical
        point (..., 3) (`deformable.py:216`)."""
        total = regist_feat.shape[0]
        k = min(num_candidates, total)
        stride = max(1, total // k)
        fc = regist_feat[::stride][:k]
        xc = xyz_canonical[::stride][:k]
        score = feat_px.reshape(-1, feat_px.shape[-1]) @ fc.T
        prob = torch.softmax(score * torch.exp(self.logsigma), dim=-1)
        return (prob @ xc).reshape(feat_px.shape[:-1] + (3,))

    def forward_project(self, xyz_matches: torch.Tensor, samples: Dict):
        """Warp matched canonical points (M, N, 3) to their frame and project:
        returns pixel xy (M, N, 2) and camera points (M, N, 3)
        (`deformable.py:232`)."""
        (q_w, t_w), _ = self._warp_qt(xyz_matches, samples)
        xyz_t = quaternion_translation_apply(q_w, t_w, xyz_matches)
        q_f, t_f = samples["field2cam"]
        xyz_cam = quaternion_translation_apply(q_f[:, None], t_f[:, None], xyz_t)
        xy = geom.pinhole_projection(geom.Kmatinv(samples["Kinv"]), xyz_cam)[..., :2]
        return xy, xyz_cam

    def gauss_density_at(self, xyz: torch.Tensor, samples: Dict) -> Optional[torch.Tensor]:
        """Bone-proxy density (...,) at canonical points (..., 3) under the
        first frame's rest articulation; None for a warp without bones
        (`deformable.py:245`)."""
        if not isinstance(self.warp, SkinningWarp):
            return None
        rest = samples["rest_articulation"]
        return self.warp.get_gauss_density(xyz, bone2obj=(rest[0][:1], rest[1][:1]))[..., 0]

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
    extra_colors: Optional[torch.Tensor] = None,  # (M, P, X)
) -> dict:
    """The tile kernels' inputs for the warped surfels of every batch frame
    (the JAX package's "pallas_grad" path of `render_surfels_batch`,
    `deformable.py:292-321`): SH colour at camera-space view dirs (camera
    at the origin) with ``extra_colors`` appended as X more channels,
    projection, binning and packing. `composite_batch` of the result
    renders the frames."""
    eye = torch.eye(4, dtype=xyz_cam.dtype, device=xyz_cam.device)
    colors = sh_ops.eval_sh_color(sh_degree, sf.get_features(params)[None], xyz_cam,
                                  torch.zeros(3, dtype=xyz_cam.dtype, device=xyz_cam.device))
    if extra_colors is not None:
        colors = torch.cat([colors, extra_colors], dim=-1)
    proj_b = project_splats(xyz_cam, rot_cam, sf.get_scaling(params), eye, intrins,
                            mask=alive, densify_dummy=densify_dummy)
    return prepare_batch(
        proj_b, colors, sf.get_opacity(params)[:, 0], bg_color, height, width,
        span_cap=config.span_cap, entry_cap=config.entry_cap, tile=config.tile,
    )


@torch.no_grad()
def render_surfels_batch(
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
) -> CompositeOutput:
    """Forward-only render of the warped surfels of every batch frame (the
    JAX package's `render_surfels_batch`, `deformable.py:259`, on its
    "pallas_grad" path): one launch of the forward tile kernel for all M
    frames and no backward. Returns a CompositeOutput of (M, H, W, ...)."""
    prepared = prepare_surfels_batch(params, alive, xyz_cam, rot_cam, intrins, height,
                                     width, sh_degree, bg_color, config)
    return composite_batch(prepared, height, width)
