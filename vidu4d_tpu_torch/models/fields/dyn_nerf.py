"""Dynamic neural SDF field: VolSDF density, neural blend skinning and a
feature head (`vidu4d_tpu/models/fields/dyn_nerf.py`).

``fg_motion`` "rigid" gives the static field (the background's), any
other warp of `warp_module` a deformable one:

* backward warp: camera rays -> time-t object space -> canonical;
* VolSDF density: the Laplace CDF of the learned SDF;
* colour MLP with optional view direction and appearance code;
* canonical feature head, softmax global matching and reprojection;
* flow by forward-warping to the paired frame's camera;
* cycle consistency, the eikonal term (``torch.autograd.grad`` with
  ``create_graph``), the gauss-bone density.

Eval renders (``train=False``) sample each ray twice (64 uniform depths,
then 64 more from their weights' CDF at evenly spaced levels) and zero the
density outside the extended aabb. `flip_pair` also serves the Stage-3
flow loss.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.embeddings import pos_embed
from vidu4d_tpu_torch.models.fields.mlp import BaseMLP, CondMLP
from vidu4d_tpu_torch.models.fields.time_mlp import AppearanceEmbedding, CameraMLP
from vidu4d_tpu_torch.models.fields.warping import SkinningWarp, warp_module
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops.numerics import safe_norm, safe_normalize
from vidu4d_tpu_torch.ops.quaternion import (
    quaternion_translation_apply,
    quaternion_translation_inverse,
    quaternion_translation_to_se3,
)
from vidu4d_tpu_torch.ops import global_batch
from vidu4d_tpu_torch.ops.volume import compute_weights, sample_cam_rays, sample_pdf
from vidu4d_tpu_torch.utils.profiler import span


class FieldState(NamedTuple):
    """Non-parameter field state, refreshed between rounds (`dyn_nerf.py:46`)."""

    aabb: torch.Tensor  # (2, 3) canonical-space bounds
    near_far: torch.Tensor  # (N_raw, 2) per-frame near/far
    proxy_pts: torch.Tensor  # (P, 3) points on the proxy geometry

    @staticmethod
    def initial(num_frames_raw: int, radius: float = 0.12, n_proxy: int = 64,
                device=None) -> "FieldState":
        """A sphere of ``radius``: its aabb, 64 points on it, near/far
        (0.1, 10) in every frame."""
        u = np.linspace(0, np.pi, 8, dtype=np.float32)
        v = np.linspace(0, 2 * np.pi, 8, dtype=np.float32)
        uu, vv = np.meshgrid(u, v)
        sphere = radius * np.stack([np.sin(uu) * np.cos(vv), np.sin(uu) * np.sin(vv),
                                    np.cos(uu)], axis=-1).reshape(-1, 3)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return FieldState(
            aabb=f32([[-radius] * 3, [radius] * 3]),
            near_far=f32(np.tile([[0.1, 10.0]], (num_frames_raw, 1))),
            proxy_pts=f32(sphere[:n_proxy]),
        )


def flip_pair(x):
    """Swap consecutive frame pairs along the leading axis
    (`dyn_nerf.py:71`). Works on tensors, (nested) tuples such as dual
    quaternions, and dicts of them."""
    if isinstance(x, tuple):
        return tuple(flip_pair(t) for t in x)
    if isinstance(x, dict):
        return {k: flip_pair(v) for k, v in x.items()}
    if x.shape[0] < 2:
        return x
    y = x.reshape((x.shape[0] // 2, 2) + tuple(x.shape[1:]))
    return y.flip(1).reshape(x.shape)


# the JAX module's fixed hyper-parameters (`dyn_nerf.py:86-101`)
NUM_FREQ_XYZ, NUM_FREQ_DIR = 10, 4
APPR_CHANNELS, INST_CHANNELS, FEATURE_CHANNELS = 32, 32, 16
INIT_BETA, INIT_SCALE = 0.1, 0.1
EVAL_DEPTH_SAMPLES = 128


class DynNeRF(nn.Module):
    """Deformable VolSDF field with feature, flow and cycle outputs
    (`dyn_nerf.py:83`). Submodule and parameter names follow the JAX
    module's, so that `vidu4d_tpu_torch.convert` maps one onto the other."""

    def __init__(self, frame_info: FrameInfo, category: str = "fg", fg_motion: str = "bob",
                 num_inst: int = 1, depth: int = 8, width: int = 256,
                 rgb_timefree: bool = False, rgb_dirfree: bool = False,
                 train_depth_samples: int = 64, device=None):
        super().__init__()
        self.category = category
        self.train_depth_samples = train_depth_samples
        self.basefield = CondMLP(3 * (2 * NUM_FREQ_XYZ + 1), num_inst, depth=depth,
                                 width=width, inst_channels=INST_CHANNELS, out_channels=width,
                                 skips=(4,), final_act=True, device=device)
        self.colorfield = CondMLP(3 * (2 * NUM_FREQ_XYZ + 5), num_inst, depth=2, width=width,
                                  inst_channels=INST_CHANNELS, out_channels=width,
                                  skips=(4,), final_act=True, device=device)
        self.sdf_head = nn.Linear(width, 1, device=device)
        self.appr_channels = 0 if rgb_timefree else APPR_CHANNELS
        if self.appr_channels > 0:
            self.appr_embedding = AppearanceEmbedding(frame_info, self.appr_channels,
                                                      device=device)
        self.num_freq_dir = -1 if rgb_dirfree else NUM_FREQ_DIR
        dir_ch = 0 if rgb_dirfree else 3 * (2 * NUM_FREQ_DIR + 1)
        self.rgb_hidden = nn.Linear(width + dir_ch + self.appr_channels, width // 2,
                                    device=device)
        self.rgb_out = nn.Linear(width // 2, 3, device=device)
        self.logibeta = nn.Parameter(torch.full((1,), -float(np.log(INIT_BETA)), device=device))
        self.logscale = nn.Parameter(torch.full((1,), float(np.log(INIT_SCALE)), device=device))
        self.camera_mlp = CameraMLP(frame_info, device=device)
        self.vis_field = CondMLP(3 * 21, num_inst, depth=2, width=64,
                                 inst_channels=INST_CHANNELS, out_channels=1, skips=(4,),
                                 device=device)
        self.feature_field = BaseMLP(3 * 13, depth=5, width=128,
                                     out_channels=FEATURE_CHANNELS, skips=(4,), device=device)
        self.logsigma = nn.Parameter(torch.zeros(1, device=device))
        self.warp = warp_module(fg_motion, frame_info, device=device)

    # ------------------------------------------------------------------
    # field queries
    # ------------------------------------------------------------------

    def sdf(self, xyz: torch.Tensor, inst_id=None, alpha=None):
        """Signed distance (negative inside) (..., 1) and the trunk feature."""
        feat = self.basefield(pos_embed(xyz, NUM_FREQ_XYZ, alpha=alpha), inst_id)
        return self.sdf_head(feat), feat

    def density_from_sdf(self, sdf: torch.Tensor) -> torch.Tensor:
        """VolSDF Laplace-CDF density (`dyn_nerf.py:143`)."""
        ibeta = torch.exp(self.logibeta)
        return (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) * ibeta)) * ibeta

    def query(self, xyz, direction=None, frame_id=None, inst_id=None, get_density=True,
              alpha=None):
        """The density (or the SDF); with a direction (rgb, density)
        (`dyn_nerf.py:148`)."""
        sdf, xyz_feat = self.sdf(xyz, inst_id=inst_id, alpha=alpha)
        out = self.density_from_sdf(sdf) if get_density else sdf
        if direction is None:
            return out
        dir_embed = pos_embed(direction, self.num_freq_dir)
        if self.appr_channels > 0:
            appr = self.appr_embedding(frame_id)
            appr = appr[:, None, None, :].expand(dir_embed.shape[:-1] + (appr.shape[-1],))
            dir_embed = torch.cat([dir_embed, appr], dim=-1)
        xyz_embed_c = pos_embed(xyz, NUM_FREQ_XYZ + 2)
        xyz_feat = xyz_feat + self.colorfield(xyz_embed_c, inst_id)
        rgb = self.rgb_out(torch.relu(self.rgb_hidden(torch.cat([xyz_feat, dir_embed], -1))))
        return torch.sigmoid(rgb), out

    def visibility(self, xyz: torch.Tensor, inst_id=None) -> torch.Tensor:
        return self.vis_field(pos_embed(xyz, 10), inst_id)

    def features(self, xyz: torch.Tensor) -> torch.Tensor:
        """Canonical feature head, L2-normalised (`dyn_nerf.py:185`)."""
        return safe_normalize(self.feature_field(pos_embed(xyz, 6)))

    # ------------------------------------------------------------------
    # camera and warps
    # ------------------------------------------------------------------

    def camera_vals(self, frame_id=None):
        return self.camera_mlp(frame_id)

    @staticmethod
    def cam_to_field(xyz_cam, dir_cam, field2cam):
        """Camera-space points and directions (M, N, D, 3) -> field space."""
        q, t = quaternion_translation_inverse(field2cam[0], field2cam[1])
        q, t = q[:, None, None], t[:, None, None]
        xyz = quaternion_translation_apply(q, t, xyz_cam)
        direction = quaternion_translation_apply(q, torch.zeros_like(t), dir_cam)
        return xyz, direction

    @staticmethod
    def field_to_cam(xyz, field2cam):
        return quaternion_translation_apply(field2cam[0][:, None, None],
                                            field2cam[1][:, None, None], xyz)

    @span("warp")
    def backward_warp(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                      samples_dict=None) -> Dict:
        xyz_t, direction = self.cam_to_field(xyz_cam, dir_cam, field2cam)
        xyz, aux = self.warp(xyz_t, frame_id, inst_id, samples_dict=samples_dict,
                             backward=True)
        return {"xyz": xyz, "dir": direction, "xyz_t": xyz_t, **aux}

    @span("warp")
    def forward_warp(self, xyz, field2cam, frame_id, inst_id, samples_dict=None):
        xyz_next, _ = self.warp(xyz, frame_id, inst_id, samples_dict=samples_dict)
        return self.field_to_cam(xyz_next, field2cam)

    # ------------------------------------------------------------------
    # rays
    # ------------------------------------------------------------------

    def get_samples(self, Kinv, batch: Dict, state: FieldState,
                    use_wide_near_far: bool = False) -> Dict:
        """The time-dependent camera and articulation of a batch
        (`dyn_nerf.py:247`). A batch "field2cam" (M, 7) replaces the camera
        MLP's, its translation scaled by exp(logscale). The articulation is
        always the MLP's: a batch "t_articulation" is not read (as in JAX)."""
        frame_id = batch["frameid"]
        if "field2cam" in batch:
            field2cam = (batch["field2cam"][..., :4],
                         batch["field2cam"][..., 4:] * torch.exp(self.logscale))
        else:
            field2cam = self.camera_vals(frame_id)
        if use_wide_near_far:
            rtmat = quaternion_translation_to_se3(field2cam[0], field2cam[1])
            near_far = geom.get_near_far(state.proxy_pts, rtmat, tol_fac=1.5)
        else:
            near_far = state.near_far[frame_id.long()]
        samples = {"Kinv": Kinv, "field2cam": field2cam, "frame_id": frame_id,
                   "inst_id": batch["dataid"], "near_far": near_far, "hxy": batch["hxy"]}
        if "feature" in batch:
            samples["feature"] = batch["feature"]
        if isinstance(self.warp, SkinningWarp):
            t_art, rest_art = self.warp.articulation.vals_and_mean(frame_id)
            samples["t_articulation"] = t_art
            samples["rest_articulation"] = rest_art
        return samples

    def query_field(self, samples: Dict, state: FieldState, train: bool = True,
                    alpha=None, flow_thresh=None, no_warp: bool = False):
        """Query the field along the batch's rays (`dyn_nerf.py:286`).
        Returns (feat_dict of (M, N, D, ...), deltas (M, N, D, 1), aux_dict
        of (M, N, ...))."""
        Kinv, field2cam = samples["Kinv"], samples["field2cam"]
        frame_id, inst_id = samples["frame_id"], samples["inst_id"]
        near_far, hxy = samples["near_far"], samples["hxy"]
        if train:
            xyz_cam, dir_cam, deltas, depth = sample_cam_rays(
                hxy, Kinv, near_far, n_depth=self.train_depth_samples)
        else:
            xyz_cam, dir_cam, deltas, depth = self._importance_sampling(
                hxy, Kinv, near_far, field2cam, frame_id, inst_id, samples, alpha=alpha)
        if no_warp:
            xyz, direction = self.cam_to_field(xyz_cam, dir_cam, field2cam)
            backwarp = {"xyz": xyz, "dir": direction, "xyz_t": xyz}
        else:
            backwarp = self.backward_warp(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                          samples_dict=samples)
        xyz, xyz_t = backwarp["xyz"], backwarp["xyz_t"]
        with span("s2.field"):
            vis_score = self.visibility(xyz, inst_id)
            rgb, density = self.query(xyz, direction=backwarp["dir"], frame_id=frame_id,
                                      inst_id=inst_id, alpha=alpha)
        if not train:
            inside = geom.check_inside_aabb(xyz, geom.extend_aabb(state.aabb))
            density = torch.where(inside[..., None], density, torch.zeros_like(density))
        feat_dict = {"rgb": rgb, "density": density, f"density_{self.category}": density,
                     "vis": vis_score}
        aux_dict = {}
        if train:
            feat_dict["flow"] = self._compute_flow(hxy, xyz, frame_id, inst_id, field2cam,
                                                   Kinv, samples, flow_thresh=flow_thresh)
            with span("warp"):
                xyz_cycled, cyc_aux = self.warp(xyz, frame_id, inst_id, samples_dict=samples)
            feat_dict["cyc_dist"] = safe_norm(xyz_cycled - xyz_t, dim=-1, keepdim=True)
            for k in ("skin_entropy", "delta_skin"):
                if k in cyc_aux and k in backwarp:
                    feat_dict[k] = (cyc_aux[k] + backwarp[k]) / 2.0
                elif k in cyc_aux:
                    feat_dict[k] = cyc_aux[k]
            feat_dict["eikonal"] = self._eikonal(xyz, inst_id, alpha=alpha)
            with span("s2.field"):
                feature = self.features(xyz)
            feat_dict["feature"] = feature
            if "feature" in samples:
                xyz_matches = self.global_match(samples["feature"], feature, xyz)
                xy_reproj, xyz_reproj = self._forward_project(
                    xyz_matches, field2cam, Kinv, frame_id, inst_id, samples)
                aux_dict.update(xyz_matches=xyz_matches, xyz_reproj=xyz_reproj,
                                xy_reproj=xy_reproj)
        if isinstance(self.warp, SkinningWarp) and "rest_articulation" in samples:
            rest = samples["rest_articulation"]
            gauss = self.warp.get_gauss_density(xyz.reshape(-1, 3),
                                                bone2obj=(rest[0][:1], rest[1][:1]))
            gauss = gauss * torch.exp(self.warp.logibeta)
            feat_dict["gauss_density"] = gauss.reshape(xyz.shape[:-1] + (1,))
        feat_dict["xyz"] = xyz
        feat_dict["xyz_cam"] = xyz_cam
        feat_dict["depth"] = depth / torch.exp(self.logscale)
        return feat_dict, deltas, aux_dict

    def _importance_sampling(self, hxy, Kinv, near_far, field2cam, frame_id, inst_id,
                             samples, alpha=None):
        """Eval-time two-pass sampling (`dyn_nerf.py:392`): half the eval
        depths uniform, half from their weights' CDF (detached)."""
        n_half = EVAL_DEPTH_SAMPLES // 2
        xyz_cam, dir_cam, deltas, depth = sample_cam_rays(hxy, Kinv, near_far, n_depth=n_half)
        xyz = self.backward_warp(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                 samples)["xyz"]
        density = self.query(xyz, frame_id=frame_id, inst_id=inst_id, alpha=alpha)
        weights, _ = compute_weights(density, deltas)
        depth_mid = 0.5 * (depth[:, :, :-1, 0] + depth[:, :, 1:, 0])
        m, n = depth.shape[:2]
        depth_new = sample_pdf(depth_mid.reshape(m * n, -1),
                               weights.reshape(m * n, -1)[:, 1:-1], n_half, det=True)
        depth_new = depth_new.detach().reshape(m, n, n_half, 1)
        depth_all = torch.sort(torch.cat([depth, depth_new], dim=-2), dim=-2).values
        return sample_cam_rays(hxy, Kinv, near_far, depth=depth_all)

    @span("s2.reg")
    def _eikonal(self, xyz, inst_id, alpha=None, sample_ratio: int = 16):
        """(|grad sdf| - 1)^2 at every ``sample_ratio``-th ray, in canonical
        space, zero elsewhere (`dyn_nerf.py:414`). The gradient is taken at
        the detached points with ``create_graph``, so that the loss reaches
        the SDF's parameters."""
        m, n, d, _ = xyz.shape
        stride = max(1, int(sample_ratio))
        pts = xyz[:, ::stride].detach().requires_grad_(True)
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            sdf, _ = self.sdf(pts, inst_id=inst_id, alpha=alpha)
            g = torch.autograd.grad(sdf.sum(), pts, create_graph=create_graph)[0]
        eik = (safe_norm(g, dim=-1, keepdim=True) - 1.0) ** 2
        out = torch.zeros((m, n, d, 1), dtype=xyz.dtype, device=xyz.device)
        out[:, ::stride] = eik
        return out

    def compute_normal(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples,
                       alpha=None):
        """Eikonal term and camera-space normals of the warped SDF
        (`dyn_nerf.py:432`); the gradient is taken with ``create_graph``."""
        pts = xyz_cam.detach().requires_grad_(True)
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            xyz = self.backward_warp(pts, dir_cam, field2cam, frame_id, inst_id,
                                     samples)["xyz"]
            sdf, _ = self.sdf(xyz, inst_id=inst_id, alpha=alpha)
            g = torch.autograd.grad(sdf.sum(), pts, create_graph=create_graph)[0]
        eikonal = (safe_norm(g, dim=-1, keepdim=True) - 1.0) ** 2
        normal = safe_normalize(g) * torch.tensor([1.0, -1.0, -1.0], dtype=g.dtype,
                                                  device=g.device)
        return eikonal, normal

    def global_match(self, feat_px, feat_canonical, xyz_canonical,
                     num_candidates: int = 1024):
        """Softmax matching of pixel features against a stride subsample of
        the canonical samples of the whole batch (`dyn_nerf.py:446`; the
        global batch when the ranks split it: `global_batch.strided_rows`)."""
        shape = feat_px.shape
        fc, xc = global_batch.strided_rows(
            [feat_canonical.reshape(-1, shape[-1]), xyz_canonical.reshape(-1, 3)],
            num_candidates)
        score = (feat_px.reshape(-1, shape[-1]) @ fc.T) * torch.exp(self.logsigma)
        prob = torch.softmax(score, dim=-1)
        return (prob @ xc).reshape(shape[:-1] + (3,))

    def _forward_project(self, xyz, field2cam, Kinv, frame_id, inst_id, samples):
        """Project matched canonical points into the frame (`dyn_nerf.py:467`)."""
        xyz_cam = self.forward_warp(xyz[:, :, None], field2cam, frame_id, inst_id,
                                    samples)[:, :, 0]
        hxy = geom.pinhole_projection(geom.Kmatinv(Kinv), xyz_cam)
        return hxy[..., :2], xyz_cam

    def _compute_flow(self, hxy, xyz, frame_id, inst_id, field2cam, Kinv, samples,
                      flow_thresh=None):
        """Flow towards the paired frame, with its validity (`dyn_nerf.py:478`)."""
        samples_next = dict(samples)
        for k in ("t_articulation", "rest_articulation"):
            if k in samples_next:
                samples_next[k] = flip_pair(samples_next[k])
        xyz_cam_next = self.forward_warp(xyz, flip_pair(field2cam), flip_pair(frame_id),
                                         inst_id, samples_dict=samples_next)
        hxy_next = geom.pinhole_projection(geom.Kmatinv(flip_pair(Kinv)), xyz_cam_next)
        flow = (hxy_next - hxy[:, :, None])[..., :2]
        valid = xyz_cam_next[..., -1:] > 1e-6
        if flow_thresh is not None:
            valid = valid & (safe_norm(flow, dim=-1, keepdim=True) < float(flow_thresh))
        return torch.cat([flow, valid.to(flow.dtype)], dim=-1)

    def gauss_skin_consistency_density(self, pts, inst_id=None, alpha=None):
        """(gauss density, detached field density / ibeta in [0, 1]) of the
        gauss-skin BCE (`dyn_nerf.py:503`)."""
        density_gauss = self.warp.get_gauss_density(pts)
        density = self.query(pts, inst_id=inst_id, alpha=alpha)
        return density_gauss, (density / torch.exp(self.logibeta)).detach()
