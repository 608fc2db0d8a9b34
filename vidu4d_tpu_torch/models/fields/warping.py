"""Warping fields (`vidu4d_tpu/models/fields/warping.py`): the rigid
`IdentityWarp` (``fg_motion`` "rigid") and the neural dual-quaternion
blend-skinning `SkinningWarp` over a flat bag of bones ("bob").

Every warp is called as ``warp(xyz, frame_id, inst_id, samples_dict=None,
backward=False, return_qt=False)`` and returns (the warped points, or the
per-point rigid transform (q, t) with ``return_qt``; an aux dict). The
other warps of the JAX package wait for later work.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.articulation import ArticulationFlatMLP
from vidu4d_tpu_torch.models.fields.skinning import (
    SkinningField,
    cross_entropy_skin_loss,
    get_xyz_bone_distance,
)
from vidu4d_tpu_torch.ops.quaternion import (
    dual_quaternion_inverse,
    dual_quaternion_mul,
    dual_quaternion_skinning,
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


class SkinningWarp(nn.Module):
    """Neural DQ blend-skinning warp over a flat bag of bones."""

    def __init__(self, frame_info: FrameInfo, num_se3: int = 25,
                 init_gauss_scale: float = 0.03, init_beta: float = 0.01,
                 delta_skin: bool = True, device=None):
        super().__init__()
        self.articulation = ArticulationFlatMLP(frame_info, num_se3=num_se3,
                                                device=device)
        self.skinning_model = SkinningField(
            num_se3, frame_info, num_inst=frame_info.num_vids,
            init_scale=init_gauss_scale, delta_skin=delta_skin, device=device)
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


def warp_module(fg_motion: str, frame_info: FrameInfo, device=None) -> nn.Module:
    """Factory for the ``fg_motion`` strings the port has (`warping.py:287`)."""
    if fg_motion == "rigid":
        return IdentityWarp()
    if fg_motion == "bob":
        return SkinningWarp(frame_info, device=device)
    raise NotImplementedError(
        f"fg_motion {fg_motion!r} is not ported yet (only 'rigid' and 'bob')")
