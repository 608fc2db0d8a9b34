"""Neural dual-quaternion blend-skinning warp
(`vidu4d_tpu/models/fields/warping.py:146-237`).

Only the bag-of-bones `SkinningWarp` (``fg_motion`` "bob") is ported; the
other warps of the JAX package wait for later work.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from vidu4d_tpu.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.articulation import ArticulationFlatMLP
from vidu4d_tpu_torch.models.fields.skinning import SkinningField, cross_entropy_skin_loss
from vidu4d_tpu_torch.ops.quaternion import (
    dual_quaternion_inverse,
    dual_quaternion_mul,
    dual_quaternion_skinning,
)


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

    def forward(self, xyz: torch.Tensor, frame_id: torch.Tensor,
                inst_id: torch.Tensor, samples_dict: Dict):
        """Forward warp (rest pose -> frame) of xyz (M, N, D, 3): returns the
        blended rigid transform (q, t) per point, and an aux dict with
        'skin_entropy' and 'delta_skin' (M, N, D, 1). The articulations come
        from ``samples_dict`` ("t_articulation", "rest_articulation"). The
        JAX module's backward warp and point outputs are not ported yet."""
        t_art = samples_dict["t_articulation"]
        rest_art = samples_dict["rest_articulation"]
        se3 = dual_quaternion_mul(t_art, dual_quaternion_inverse(rest_art))
        # skinning at the rest pose, with the mean time code
        articulation = (rest_art[0][:, None, None], rest_art[1][:, None, None])
        skin, delta_skin = self.skinning_model(xyz, articulation, None, inst_id)
        skin_prob = torch.softmax(skin, dim=-1)
        out = dual_quaternion_skinning(se3, xyz, skin_prob, return_qt=True)
        aux = {"skin_entropy": cross_entropy_skin_loss(skin)[..., None]}
        if delta_skin is not None:
            aux["delta_skin"] = torch.mean(delta_skin ** 2, dim=-1, keepdim=True)
        return out, aux


def warp_module(fg_motion: str, frame_info: FrameInfo, device=None) -> nn.Module:
    """Factory for the ``fg_motion`` strings the port has (`warping.py:287`)."""
    if fg_motion == "bob":
        return SkinningWarp(frame_info, device=device)
    raise NotImplementedError(f"fg_motion {fg_motion!r} is not ported yet (only 'bob')")
