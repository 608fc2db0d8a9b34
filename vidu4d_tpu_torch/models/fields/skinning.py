"""Gaussian-bone skinning field (`vidu4d_tpu/models/fields/skinning.py`)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.embeddings import TimeEmbedding, pos_embed
from vidu4d_tpu_torch.models.fields.mlp import CondMLP
from vidu4d_tpu_torch.ops.point_reduce import reduce_points
from vidu4d_tpu_torch.ops.quaternion import (
    DualQuaternion,
    dual_quaternion_apply,
    dual_quaternion_inverse,
    dual_quaternion_to_quaternion_translation,
    quaternion_to_matrix,
)


class _BoneRotate(torch.autograd.Function):
    """``einsum("mbij,mnj->mnbi", rmat, xyz)``: points (M, N, 3) into every
    bone's frame by its rotation (M, B, 3, 3). The rotations' gradient, a
    sum over the N points, goes to `reduce_points`."""

    @staticmethod
    def forward(ctx, rmat, xyz):
        ctx.save_for_backward(rmat, xyz)
        return torch.einsum("mbij,mnj->mnbi", rmat, xyz)

    @staticmethod
    def backward(ctx, g):
        rmat, xyz = ctx.saved_tensors
        m, b = rmat.shape[:2]
        g2 = g.reshape(m, g.shape[1], b * 3)
        g_rmat = g_xyz = None
        if ctx.needs_input_grad[0]:
            g_rmat = reduce_points(g2, xyz).reshape(rmat.shape)
        if ctx.needs_input_grad[1]:
            g_xyz = torch.bmm(g2, rmat.reshape(m, b * 3, 3))
        return g_rmat, g_xyz


def get_bone_coords(xyz: torch.Tensor, bone2obj: DualQuaternion) -> torch.Tensor:
    """Object-space points -> per-bone coordinates (`skinning.py:27`).

    The DQ inverse runs on the per-bone arrays; when the bones are per frame
    only (the skinning hot path) it is applied to the points as one matmul,
    x_bone = R_b x + t_b (`_BoneRotate`).

    xyz (..., 3); bone2obj ((..., B, 4), (..., B, 4)) broadcastable -> (..., B, 3)
    """
    obj2bone = dual_quaternion_inverse(bone2obj)
    q, t = dual_quaternion_to_quaternion_translation(obj2bone)
    b = q.shape[-2]
    lead_b = q.shape[:-2]
    lead_x = xyz.shape[:-1]
    if len(lead_b) >= 1 and lead_b[0] == lead_x[0] and all(d == 1 for d in lead_b[1:]):
        m = lead_x[0]
        rmat = quaternion_to_matrix(q.reshape(m, b, 4))  # (M, B, 3, 3)
        xb = _BoneRotate.apply(rmat, xyz.reshape(m, -1, 3))
        xb = xb.reshape(lead_x + (b, 3))
        return xb + t.reshape((m,) + (1,) * (len(lead_x) - 1) + (b, 3))
    xyz_e = xyz[..., None, :].expand(lead_x + (b, 3))
    return dual_quaternion_apply(obj2bone, xyz_e)


def get_xyz_bone_distance(xyz: torch.Tensor, bone2obj: DualQuaternion) -> torch.Tensor:
    """Squared distance (..., B) of points (..., 3) to the bone centers
    (`skinning.py:72`)."""
    _, center = dual_quaternion_to_quaternion_translation(bone2obj)
    return torch.sum((xyz[..., None, :] - center) ** 2, dim=-1)


def arap_bone_loss(bones_t1: torch.Tensor, bones_t2: torch.Tensor,
                   k: int = 10) -> torch.Tensor:
    """As-rigid-as-possible rigidity of bone centers (B, 3) between two
    frames: keep the distances to each bone's K nearest bones at t1
    (`skinning.py:92`)."""
    d1 = torch.sum((bones_t1[:, None] - bones_t1[None]) ** 2, dim=-1)
    d2 = torch.sum((bones_t2[:, None] - bones_t2[None]) ** 2, dim=-1)
    b = bones_t1.shape[0]
    k = min(k, b - 1)
    big = torch.amax(d1) + 1.0
    d1_self = d1 + torch.eye(b, dtype=d1.dtype, device=d1.device) * big
    _, idx = torch.topk(-d1_self, k, dim=1)  # (B, K) nearest neighbours at t1
    l1 = torch.sqrt(torch.clamp(torch.gather(d1, 1, idx), min=1e-12))
    l2 = torch.sqrt(torch.clamp(torch.gather(d2, 1, idx), min=1e-12))
    return torch.mean((l1 - l2) ** 2)


def cross_entropy_skin_loss(skin: torch.Tensor) -> torch.Tensor:
    """CE between skin logits and their one-hot argmax (`skinning.py:78`)."""
    log_prob = torch.log_softmax(skin, dim=-1)
    return -torch.gather(log_prob, -1, torch.argmax(skin, dim=-1, keepdim=True))[..., 0]


class SkinningField(nn.Module):
    """Per-bone 3D Gaussian skinning weights + optional delta-skin MLP.
    ``symm_idx`` (a skeleton's mirror index of each bone) averages each
    bone's Gaussian scales with its mirror's."""

    def __init__(self, num_coords: int, frame_info: FrameInfo, num_inst: int,
                 delta_skin: bool = True, depth: int = 2, width: int = 64,
                 num_freq_xyz: int = 0, num_freq_t: int = 6, inst_channels: int = 32,
                 init_scale: float = 0.03, symm_idx: Optional[Tuple[int, ...]] = None,
                 device=None):
        super().__init__()
        self.num_freq_xyz = num_freq_xyz
        self.symm_idx = None if symm_idx is None else list(symm_idx)
        self.log_gauss = nn.Parameter(
            torch.full((num_coords, 3), math.log(init_scale), device=device))
        self.delta_skin = delta_skin
        if delta_skin:
            self.time_embedding = TimeEmbedding(num_freq_t, frame_info, device=device)
            in_ch = 3 * num_coords * (2 * num_freq_xyz + 1) \
                if num_freq_xyz > 0 else 3 * num_coords
            self.delta_field = CondMLP(
                in_ch + 128, num_inst=num_inst, depth=depth, width=width,
                out_channels=num_coords, inst_channels=inst_channels, skips=(4,),
                device=device)

    def get_gauss(self) -> torch.Tensor:
        """(B, 3) per-bone Gaussian scales (`skinning.py:148`)."""
        log_gauss = self.log_gauss
        if self.symm_idx is not None:
            log_gauss = (log_gauss[self.symm_idx] + log_gauss) / 2.0
        return torch.exp(log_gauss)

    def forward(self, xyz: torch.Tensor, bone2obj: DualQuaternion,
                frame_id: Optional[torch.Tensor], inst_id: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """xyz (M, N, D, 3) -> (skin logits (M, N, D, B), delta or None)."""
        xyz_bone = get_bone_coords(xyz, bone2obj) / self.get_gauss()
        dist2 = torch.sum(xyz_bone ** 2, dim=-1)
        if not self.delta_skin:
            return -dist2, None
        xyz_embed = pos_embed(xyz_bone.reshape(xyz.shape[:-1] + (-1,)), self.num_freq_xyz)
        t_embed = (self.time_embedding.mean_embedding() if frame_id is None
                   else self.time_embedding(frame_id))
        t_embed = t_embed.reshape((-1,) + (1,) * (xyz.dim() - 2) + (t_embed.shape[-1],))
        t_embed = t_embed.expand(xyz.shape[:-1] + (t_embed.shape[-1],))
        embed = torch.cat([xyz_embed, t_embed], dim=-1)
        delta = torch.relu(self.delta_field(embed, inst_id)) * 0.1
        return -(dist2 + delta), delta
