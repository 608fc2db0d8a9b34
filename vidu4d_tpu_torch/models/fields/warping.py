"""Warping fields (`vidu4d_tpu/models/fields/warping.py`): the rigid
`IdentityWarp`, the dense `DenseWarp` and `DenseWarpSE3`, the neural
dual-quaternion blend-skinning `SkinningWarp` over a bag of bones or a
predefined skeleton, the `ComposedWarp` of skinning and a soft dense
post-warp, and `NVPWarp` (`nvp.py`). `warp_module` maps the ``fg_motion``
strings of the JAX package onto them.

Every warp is called as ``warp(xyz, frame_id, inst_id, samples_dict=None,
backward=False, return_qt=False)`` and returns (the warped points, or the
per-point rigid transform (q, t) with ``return_qt``; an aux dict). The
dense, composed and NVP warps have no SE(3) form: ``return_qt`` raises
NotImplementedError, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.articulation import ArticulationFlatMLP
from vidu4d_tpu_torch.models.fields.embeddings import TimeEmbedding, pos_embed
from vidu4d_tpu_torch.models.fields.mlp import CondMLP
from vidu4d_tpu_torch.models.fields.nvp import NVPWarp
from vidu4d_tpu_torch.models.fields.skeleton import ArticulationSkelMLP
from vidu4d_tpu_torch.models.fields.skinning import (
    SkinningField,
    cross_entropy_skin_loss,
    get_xyz_bone_distance,
)
from vidu4d_tpu_torch.ops.quaternion import (
    axis_angle_to_quaternion,
    dual_quaternion_inverse,
    dual_quaternion_mul,
    dual_quaternion_skinning,
    quaternion_translation_inverse,
)

class IdentityWarp(nn.Module):
    """Rigid warp: no deformation (`warping.py:41`)."""

    def forward(self, xyz: torch.Tensor, frame_id=None, inst_id=None,
                samples_dict: Optional[Dict] = None, backward: bool = False,
                return_qt: bool = False):
        if return_qt:
            q = torch.zeros(xyz.shape[:-1] + (4,), dtype=xyz.dtype, device=xyz.device)
            q[..., 0] = 1.0
            return (q, torch.zeros_like(xyz)), {}
        return xyz, {}


class _TimedEmbed(nn.Module):
    """The input of the dense warps' MLPs: the points' Fourier embedding
    and the frames' time code (`warping.py:84`)."""

    def __init__(self, frame_info: FrameInfo, num_freq_xyz: int, num_freq_t: int,
                 device=None):
        super().__init__()
        self.num_freq_xyz = num_freq_xyz
        self.time_embedding = TimeEmbedding(num_freq_t, frame_info, device=device)
        self.channels = 3 * (2 * num_freq_xyz + 1) + 128

    def embed(self, xyz: torch.Tensor, frame_id: torch.Tensor) -> torch.Tensor:
        """xyz (M, ..., 3), frame_id (M,) -> (M, ..., channels)."""
        t_embed = self.time_embedding(frame_id)
        t_embed = t_embed.reshape((-1,) + (1,) * (xyz.dim() - 2) + (t_embed.shape[-1],))
        t_embed = t_embed.expand(xyz.shape[:-1] + (t_embed.shape[-1],))
        return torch.cat([pos_embed(xyz, self.num_freq_xyz), t_embed], dim=-1)


class DenseWarp(_TimedEmbed):
    """D-NeRF-style dense translation field: separate forward and backward
    MLPs, xyz + 0.1 x motion (`warping.py:60`). No SE(3) form."""

    def __init__(self, frame_info: FrameInfo, num_freq_xyz: int = 6, num_freq_t: int = 6,
                 depth: int = 6, width: int = 256, device=None):
        super().__init__(frame_info, num_freq_xyz, num_freq_t, device=device)
        n = frame_info.num_vids
        self.forward_map = CondMLP(self.channels, n, depth=depth, width=width,
                                   out_channels=3, device=device)
        self.backward_map = CondMLP(self.channels, n, depth=depth, width=width,
                                    out_channels=3, device=device)

    def forward(self, xyz: torch.Tensor, frame_id: torch.Tensor, inst_id: torch.Tensor,
                samples_dict: Optional[Dict] = None, backward: bool = False,
                return_qt: bool = False):
        if return_qt:
            raise NotImplementedError("DenseWarp has no SE(3) form")
        embed = self.embed(xyz, frame_id)
        mlp = self.backward_map if backward else self.forward_map
        return xyz + mlp(embed, inst_id) * 0.1, {}


class DenseWarpSE3(_TimedEmbed):
    """Per-point rotation + translation dense warp (`warping.py:104`): an
    axis-angle head and a translation head scaled by ``trans_scaling``; the
    backward warp is their inverse. Without ``return_qt`` only the
    translation moves the points, as in the JAX package."""

    def __init__(self, frame_info: FrameInfo, num_freq_xyz: int = 6, num_freq_t: int = 6,
                 depth: int = 6, width: int = 256, device=None):
        super().__init__(frame_info, num_freq_xyz, num_freq_t, device=device)
        n = frame_info.num_vids
        self.trans_scaling = nn.Parameter(torch.full((1,), 0.1, device=device))
        self.forward_map_trans = CondMLP(self.channels, n, depth=depth, width=width // 2,
                                         out_channels=3, device=device)
        self.forward_map_rot = CondMLP(self.channels, n, depth=depth, width=width // 2,
                                       out_channels=3, device=device)

    def forward(self, xyz: torch.Tensor, frame_id: torch.Tensor, inst_id: torch.Tensor,
                samples_dict: Optional[Dict] = None, backward: bool = False,
                return_qt: bool = False):
        embed = self.embed(xyz, frame_id)
        trans = self.forward_map_trans(embed, inst_id) * self.trans_scaling
        qr = axis_angle_to_quaternion(self.forward_map_rot(embed, inst_id))
        if backward:
            qr, trans = quaternion_translation_inverse(qr, trans)
        if return_qt:
            return (qr, trans), {}
        return xyz + trans, {}


class SkinningWarp(nn.Module):
    """Neural DQ blend-skinning warp (`warping.py:146`): ``skel_type``
    "flat" is a bag of ``num_se3`` bones, "human" / "quad" a predefined
    skeleton (its bone count, its mirror-averaged Gaussians)."""

    def __init__(self, frame_info: FrameInfo, num_se3: int = 25, skel_type: str = "flat",
                 init_gauss_scale: float = 0.03, init_beta: float = 0.01,
                 delta_skin: bool = True, device=None):
        super().__init__()
        if skel_type == "flat":
            self.articulation = ArticulationFlatMLP(frame_info, num_se3=num_se3,
                                                    device=device)
            symm_idx = None
        else:
            self.articulation = ArticulationSkelMLP(frame_info, skel_type=skel_type,
                                                    device=device)
            num_se3, symm_idx = self.articulation.num_se3, self.articulation.symm_idx
        self.skinning_model = SkinningField(
            num_se3, frame_info, num_inst=frame_info.num_vids,
            init_scale=init_gauss_scale, delta_skin=delta_skin, symm_idx=symm_idx,
            device=device)
        self.logibeta = nn.Parameter(
            torch.full((1,), -math.log(init_beta), device=device))

    def forward(self, xyz: torch.Tensor, frame_id: torch.Tensor, inst_id: torch.Tensor,
                samples_dict: Optional[Dict] = None, backward: bool = False,
                return_qt: bool = False):
        """Blend-skinning warp of xyz (M, N, D, 3) (`warping.py:197`).

        Forward (rest pose -> frame): se3 = t_art o rest_art^-1, skinning
        at the rest pose with the mean time code. Backward (frame -> rest
        pose): se3 = rest_art o t_art^-1, skinning at the frame's pose,
        conditioned on ``frame_id``. The articulations come from
        ``samples_dict`` ("t_articulation", "rest_articulation") when it
        holds both, else from the articulation MLP at ``frame_id``. Returns
        the warped points, or with ``return_qt`` the blended rigid transform
        (q, t) per point, and an aux dict with 'skin_entropy' and
        'delta_skin' (M, N, D, 1)."""
        if samples_dict and "t_articulation" in samples_dict \
                and "rest_articulation" in samples_dict:
            t_art = samples_dict["t_articulation"]
            rest_art = samples_dict["rest_articulation"]
        else:
            t_art, rest_art = self.articulation.vals_and_mean(frame_id)
        if backward:
            se3 = dual_quaternion_mul(rest_art, dual_quaternion_inverse(t_art))
            articulation, skin_frame_id = t_art, frame_id
        else:
            se3 = dual_quaternion_mul(t_art, dual_quaternion_inverse(rest_art))
            articulation, skin_frame_id = rest_art, None
        # the articulation stays at (M, 1, 1, B, 4): the bone transforms are
        # computed per bone and broadcast over the points
        articulation = (articulation[0][:, None, None], articulation[1][:, None, None])
        skin, delta_skin = self.skinning_model(xyz, articulation, skin_frame_id, inst_id)
        skin_prob = torch.softmax(skin, dim=-1)
        out = dual_quaternion_skinning(se3, xyz, skin_prob, return_qt=return_qt)
        aux = {"skin_entropy": cross_entropy_skin_loss(skin)[..., None]}
        if delta_skin is not None:
            aux["delta_skin"] = torch.mean(delta_skin ** 2, dim=-1, keepdim=True)
        return out, aux

    def get_gauss_density(self, xyz: torch.Tensor, bone2obj=None) -> torch.Tensor:
        """Bone-proxy density (..., 1) at points (..., 3): the hard max over
        per-bone spherical Gaussians of radius 0.01 around the bone centres
        (``bone2obj``, default the rest pose) (`warping.py:239`)."""
        if bone2obj is None:
            bone2obj = self.articulation.mean_vals()
        dist2 = get_xyz_bone_distance(xyz, bone2obj) / (0.01 ** 2)
        return torch.amax(torch.exp(-0.5 * dist2), dim=-1)[..., None]

    def get_gauss_sdf(self, xyz: torch.Tensor, bias: float = 0.0) -> torch.Tensor:
        density = torch.clamp(self.get_gauss_density(xyz), 1e-6, 1 - 1e-6)
        return -torch.logit(density) + bias


class ComposedWarp(nn.Module):
    """Skinning warp composed with a soft 2 x 256 `DenseWarp` post-warp
    (`warping.py:252`): forward = skinning after the post-warp's forward
    map, backward = the post-warp's backward map after skinning. It is not
    a `SkinningWarp`: the fields cache no articulation for it. No SE(3)
    form."""

    def __init__(self, frame_info: FrameInfo, num_se3: int = 25, skel_type: str = "flat",
                 device=None):
        super().__init__()
        self.skin_warp = SkinningWarp(frame_info, num_se3=num_se3, skel_type=skel_type,
                                      device=device)
        self.post_warp = DenseWarp(frame_info, depth=2, width=256, device=device)

    def forward(self, xyz: torch.Tensor, frame_id: torch.Tensor, inst_id: torch.Tensor,
                samples_dict: Optional[Dict] = None, backward: bool = False,
                return_qt: bool = False):
        if return_qt:
            raise NotImplementedError("ComposedWarp has no SE(3) form")
        if not backward and frame_id is not None:
            xyz, _ = self.post_warp(xyz, frame_id, inst_id)
        out, aux = self.skin_warp(xyz, frame_id, inst_id, samples_dict=samples_dict,
                                  backward=backward)
        if backward and frame_id is not None:
            out, _ = self.post_warp(out, frame_id, inst_id, backward=True)
        return out, aux

    def compute_post_warp_dist2(self, xyz: torch.Tensor, frame_id: torch.Tensor,
                                inst_id: torch.Tensor) -> torch.Tensor:
        """Half of |forward(x) - x|^2 + |forward(x) - backward(forward(x))|^2
        per point (`warping.py:279`): the soft-deform regulariser."""
        xyz_t, _ = self.post_warp(xyz, frame_id, inst_id)
        dist2 = torch.sum((xyz_t - xyz) ** 2, dim=-1)
        xyz_back, _ = self.post_warp(xyz_t, frame_id, inst_id, backward=True)
        return (dist2 + torch.sum((xyz_t - xyz_back) ** 2, dim=-1)) * 0.5


def warp_module(fg_motion: str, frame_info: FrameInfo, device=None) -> nn.Module:
    """The warp of an ``fg_motion`` string (`warping.py:287`): "rigid",
    "dense", "denseSE3", "bob", "bob-nosoft", "bob-sc" (100 bones),
    "nvp", "skel-<human|quad>" and "comp*" ("comp_skel-<type>_..." composes
    that skeleton, any other "comp" string a bag of bones)."""
    if fg_motion == "rigid":
        return IdentityWarp()
    if fg_motion == "dense":
        return DenseWarp(frame_info, device=device)
    if fg_motion == "denseSE3":
        return DenseWarpSE3(frame_info, device=device)
    if fg_motion == "bob":
        return SkinningWarp(frame_info, device=device)
    if fg_motion == "bob-nosoft":
        return SkinningWarp(frame_info, delta_skin=False, device=device)
    if fg_motion == "bob-sc":
        return SkinningWarp(frame_info, delta_skin=False, num_se3=100, device=device)
    if fg_motion == "nvp":
        return NVPWarp(frame_info, device=device)
    if fg_motion.startswith("skel-"):
        return SkinningWarp(frame_info, skel_type=fg_motion.split("-")[1], device=device)
    if fg_motion.startswith("comp"):
        parts = fg_motion.split("_")
        skel = parts[1].split("-")[1] if len(parts) > 1 and "skel" in parts[1] else "flat"
        return ComposedWarp(frame_info, skel_type=skel, device=device)
    raise NotImplementedError(f"fg_motion {fg_motion!r}")
