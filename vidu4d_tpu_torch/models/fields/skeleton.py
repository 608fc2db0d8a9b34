"""Skeleton articulation: the predefined human and quadruped kinematic
trees, forward kinematics and the skeleton MLP
(`vidu4d_tpu/models/fields/skeleton.py`).

Per-frame joint axis-angles come from a time MLP, per-instance bone lengths
are averaged with their left/right mirror, and forward kinematics turns
them into bone-to-object dual quaternions. FK is a Python loop over the
topologically ordered edge table (at most 25 bones).

The rest-joint tables are the JAX package's constants (GL coordinates,
flipped to CV by `get_predefined_skeleton`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.mlp import CondMLP
from vidu4d_tpu_torch.models.fields.time_mlp import Head, TimeMLPTrunk
from vidu4d_tpu_torch.ops.geometry import so3_to_exp_map
from vidu4d_tpu_torch.ops.quaternion import (
    DualQuaternion,
    dual_quaternion_to_quaternion_translation,
    matrix_to_quaternion,
    quaternion_translation_to_dual_quaternion,
)

# joint -> parent tables (1-indexed; 0 = the fixed base), topologically ordered
HUMAN_PARENT = {
    1: 0, 13: 0, 16: 0, 2: 1, 3: 2, 4: 3, 5: 3, 9: 3, 6: 5, 7: 6, 8: 7,
    10: 9, 11: 10, 12: 11, 14: 13, 15: 14, 17: 16, 18: 17,
}
HUMAN_SYMM = {1: 1, 2: 2, 3: 3, 4: 4, 5: 9, 6: 10, 7: 11, 8: 12, 9: 5,
              10: 6, 11: 7, 12: 8, 13: 16, 14: 17, 15: 18, 16: 13, 17: 14,
              18: 15}
QUAD_PARENT = {
    1: 0, 13: 0, 18: 0, 22: 0, 2: 1, 3: 2, 4: 3, 5: 3, 9: 3, 6: 5, 7: 6,
    8: 7, 10: 9, 11: 10, 12: 11, 14: 13, 15: 14, 16: 15, 17: 16, 19: 18,
    20: 19, 21: 20, 23: 22, 24: 23, 25: 24,
}
QUAD_SYMM = {1: 1, 2: 2, 3: 3, 4: 4, 5: 9, 6: 10, 7: 11, 8: 12, 9: 5,
             10: 6, 11: 7, 12: 8, 13: 13, 14: 14, 15: 15, 16: 16, 17: 17,
             18: 22, 19: 23, 20: 24, 21: 25, 22: 18, 23: 19, 24: 20, 25: 21}

# rest joints with the base as row 0 (GL coordinates)
_HUMAN_REST = np.array([
    [0.0, 0.0, 0.0],
    [-3.6278e-05, 3.6903e-03, -7.2475e-04],
    [-9.3221e-05, 8.0693e-03, -1.1619e-03],
    [-1.2457e-04, 1.3251e-02, -1.3801e-03],
    [-6.0306e-05, 1.8105e-02, -7.8039e-04],
    [2.2711e-03, 1.6784e-02, -8.8300e-04],
    [7.1616e-03, 1.6918e-02, -1.6573e-03],
    [1.7433e-02, 1.6934e-02, -1.7350e-03],
    [2.7266e-02, 1.6963e-02, -1.7920e-03],
    [-2.4980e-03, 1.6817e-02, -9.5435e-04],
    [-7.4151e-03, 1.6886e-02, -1.9168e-03],
    [-1.7819e-02, 1.6867e-02, -1.7721e-03],
    [-2.7194e-02, 1.6867e-02, -1.6701e-03],
    [3.4517e-03, -2.5785e-03, 4.9599e-04],
    [3.3529e-03, -1.8460e-02, 2.0430e-04],
    [3.3907e-03, -3.4376e-02, -7.4148e-04],
    [-3.4360e-03, -2.6853e-03, 2.9919e-05],
    [-3.3118e-03, -1.8488e-02, 2.1094e-04],
    [-3.3864e-03, -3.4373e-02, -7.9789e-04],
], np.float32) * 2.5

_QUAD_REST = np.array([
    [0.0, 0.01, 0.03],
    [-9.3610e-05, 1.0187e-03, -2.1873e-02],
    [-5.4921e-05, 1.7428e-03, -9.3399e-03],
    [-8.7874e-05, 2.8378e-03, 4.7383e-03],
    [-6.6505e-05, 1.9184e-02, 1.9050e-02],
    [6.6107e-03, 8.1839e-03, 1.1086e-02],
    [9.1702e-03, -7.7618e-03, 1.0090e-02],
    [1.0476e-02, -2.7165e-02, 6.9399e-03],
    [1.1353e-02, -3.5803e-02, 1.1250e-02],
    [-6.9130e-03, 8.2406e-03, 1.1061e-02],
    [-9.5720e-03, -7.6817e-03, 1.0104e-02],
    [-1.0856e-02, -2.7090e-02, 7.0649e-03],
    [-1.1773e-02, -3.5696e-02, 1.1439e-02],
    [3.2358e-05, 6.6986e-03, -4.5738e-02],
    [9.5675e-05, 3.9485e-03, -5.4802e-02],
    [1.6878e-04, 3.1219e-03, -6.3845e-02],
    [2.2074e-04, 4.3004e-03, -7.3049e-02],
    [2.0674e-04, 6.3312e-03, -8.2086e-02],
    [7.4309e-03, -2.5624e-03, -3.3335e-02],
    [7.9435e-03, -1.7319e-02, -3.6508e-02],
    [8.1728e-03, -2.8493e-02, -3.9845e-02],
    [8.5748e-03, -3.3565e-02, -3.7078e-02],
    [-7.5478e-03, -2.5571e-03, -3.3397e-02],
    [-8.2738e-03, -1.7257e-02, -3.6706e-02],
    [-8.6677e-03, -2.8381e-02, -4.0128e-02],
    [-9.1048e-03, -3.3482e-02, -3.7373e-02],
], np.float32)


def get_predefined_skeleton(skel_type: str):
    """(rest joints (B, 3) float32 in CV coordinates, the edge table, the
    mirror index of each bone) of "human" or "quad" (`skeleton.py:105`): the
    GL -> CV flip of y and z, the base row dropped and added to the
    others."""
    if skel_type == "human":
        rest, edges, symm = _HUMAN_REST.copy(), HUMAN_PARENT, HUMAN_SYMM
    elif skel_type == "quad":
        rest, edges, symm = _QUAD_REST.copy(), QUAD_PARENT, QUAD_SYMM
    else:
        raise ValueError(f"unknown skeleton {skel_type!r}")
    rest[:, 1:] *= -1
    rest = rest[1:] + rest[:1]
    return rest, edges, [v - 1 for v in symm.values()]


def get_valid_edges(edges: Dict[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(child, parent) 0-indexed bone indices of the edges with a parent bone."""
    idx = np.asarray(list(edges.keys()))
    parent = np.asarray(list(edges.values()))
    keep = parent > 0
    return idx[keep] - 1, parent[keep] - 1


def rest_joints_to_local(rest_joints: np.ndarray, edges: Dict[int, int]) -> np.ndarray:
    """child - parent for every non-root joint, numpy (`skeleton.py:130`)."""
    idx, parent = get_valid_edges(edges)
    local = rest_joints.copy()
    local[idx] = rest_joints[idx] - rest_joints[parent]
    return local


def fk_se3(local_rest_joints: torch.Tensor, so3: torch.Tensor,
           edges: Dict[int, int]) -> DualQuaternion:
    """Forward kinematics (`skeleton.py:136`): local rest joints (..., B, 3)
    and joint axis-angles (..., B, 3) -> bone-to-object dual quaternions
    ((..., B, 4), (..., B, 4))."""
    rot = so3_to_exp_map(so3)
    glob_r = [None] * rot.shape[-3]
    glob_t = [None] * rot.shape[-3]
    for idx, parent in edges.items():
        i = idx - 1
        r_i, t_i = rot[..., i, :, :], local_rest_joints[..., i, :]
        if parent > 0:
            pr, pt = glob_r[parent - 1], glob_t[parent - 1]
            glob_r[i] = pr @ r_i
            glob_t[i] = (pr @ t_i[..., None])[..., 0] + pt
        else:
            glob_r[i], glob_t[i] = r_i, t_i
    r = torch.stack(glob_r, dim=-3)
    t = torch.stack(glob_t, dim=-2)
    return quaternion_translation_to_dual_quaternion(matrix_to_quaternion(r), t)


def shift_joints_to_bones(joints: torch.Tensor, edges: Dict[int, int]) -> torch.Tensor:
    """Joint locations (..., B, 3) -> bone centres (`skeleton.py:170`): each
    parent moves to the mean of the midpoints to its children (to the one
    midpoint for one child), the others stay. The JAX package writes the
    midpoints with duplicate indices, then overwrites each parent of more
    than one child with their mean. Here each joint gathers its children's
    midpoints (padded with zeros) and sums them in a fixed order: no
    scatter, so the result is the same on every run and device."""
    idx, parent = get_valid_edges(edges)
    center = (joints[..., parent, :] + joints[..., idx, :]) / 2.0
    children = [np.flatnonzero(parent == b) for b in range(joints.shape[-2])]
    width = max(len(c) for c in children)
    pad = np.array([list(c) + [0] * (width - len(c)) for c in children])
    keep = np.array([[1.0] * len(c) + [0.0] * (width - len(c)) for c in children])
    dev, dt = joints.device, joints.dtype
    sums = torch.sum(center[..., torch.as_tensor(pad, device=dev), :]
                     * torch.as_tensor(keep[..., None], dtype=dt, device=dev), dim=-2)
    n = torch.as_tensor(np.maximum(keep.sum(1), 1)[:, None], dtype=dt, device=dev)
    has_child = torch.as_tensor(keep.sum(1)[:, None] > 0, device=dev)
    return torch.where(has_child, sums / n, joints)


def shift_joints_to_bones_dq(dq: DualQuaternion, edges: Dict[int, int],
                             shift: Optional[torch.Tensor] = None) -> DualQuaternion:
    quat, joints = dual_quaternion_to_quaternion_translation(dq)
    if shift is not None:
        joints = joints + shift
    return quaternion_translation_to_dual_quaternion(quat, shift_joints_to_bones(joints, edges))


class ArticulationSkelMLP(nn.Module):
    """Skeleton articulation over time (`skeleton.py:197`): a time MLP with
    a per-joint so3 head, a global log bone scale, a root shift and a
    per-instance bone-length MLP."""

    def __init__(self, frame_info: FrameInfo, skel_type: str = "quad", depth: int = 5,
                 width: int = 256, num_freq_t: int = 6, device=None):
        super().__init__()
        rest, self.edges, symm_idx = get_predefined_skeleton(skel_type)
        self.num_se3 = len(rest)
        self.symm_idx = tuple(symm_idx)
        # the local rest joints, in float32 as the JAX package computes them
        self.register_buffer("local_rest_joints", torch.as_tensor(
            rest_joints_to_local(rest, self.edges), device=device), persistent=False)
        self.time_mlp = TimeMLPTrunk(frame_info, depth, width, num_freq_t, device=device)
        self.so3_head = Head(width, 3 * self.num_se3, hidden=width // 2, device=device)
        self.logscale = nn.Parameter(torch.zeros(1, device=device))
        self.shift = nn.Parameter(torch.zeros(3, device=device))
        self.log_bone_len = CondMLP(1, frame_info.num_vids, depth=2, width=64,
                                    out_channels=self.num_se3, device=device)

    def compute_rel_rest_joints(self, inst_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Local rest joints (n, B, 3) scaled by the bone lengths
        exp(inc + logscale), each averaged with its mirror's; n = 1 without
        ``inst_id`` (`skeleton.py:227`). The bone-length MLP reads a
        constant 1."""
        n = 1 if inst_id is None else inst_id.shape[0]
        rel = self.local_rest_joints.to(self.logscale.dtype)[None].expand(
            (n,) + tuple(self.local_rest_joints.shape))
        inc = self.log_bone_len(torch.ones((n, 1), dtype=self.logscale.dtype,
                                           device=self.logscale.device), inst_id)
        bone_len = torch.exp(inc + self.logscale)
        bone_len = (bone_len + bone_len[..., list(self.symm_idx)]) / 2.0
        return rel * bone_len[..., None]

    def _so3(self, t_feat: torch.Tensor) -> torch.Tensor:
        return self.so3_head(t_feat).reshape(t_feat.shape[:-1] + (self.num_se3, 3))

    def _fk(self, so3: torch.Tensor, local: torch.Tensor) -> DualQuaternion:
        return shift_joints_to_bones_dq(fk_se3(local, so3, self.edges), self.edges,
                                        shift=self.shift)

    def forward(self, frame_id: Optional[torch.Tensor] = None,
                override_so3: Optional[torch.Tensor] = None) -> DualQuaternion:
        """Bone-to-object transforms ((..., B, 4), (..., B, 4)) at raw frame
        ids (every mapped frame if None); ``override_so3`` (..., B, 3)
        replaces the MLP's joint angles."""
        frame_id = self.time_mlp.frames(frame_id)
        so3 = self._so3(self.time_mlp(frame_id)) if override_so3 is None else override_so3
        return self._fk(so3, self.compute_rel_rest_joints(self.time_mlp.vid_of(frame_id)))

    def so3_at(self, frame_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The joint angles (..., B, 3) at raw frame ids."""
        return self._so3(self.time_mlp(self.time_mlp.frames(frame_id)))

    def mean_vals(self) -> DualQuaternion:
        """The rest pose ((1, B, 4), (1, B, 4)): joint angles of the mean
        time code, the mean instance's bone lengths."""
        return self._fk(self._so3(self.time_mlp.mean_feat()), self.compute_rel_rest_joints())

    def vals_and_mean(self, frame_id: Optional[torch.Tensor] = None):
        """(t_articulation, rest_articulation broadcast to match)."""
        pred_t = self(frame_id)
        mean = self.mean_vals()
        return pred_t, (mean[0].expand_as(pred_t[0]), mean[1].expand_as(pred_t[1]))

    def skel_prior_loss(self) -> torch.Tensor:
        """mean(so3^2) of the mean time code + 0.02 mean(inc^2) of the bone
        lengths (`skeleton.py:272`)."""
        loss_so3 = torch.mean(self._so3(self.time_mlp.mean_feat()) ** 2)
        inc = self.log_bone_len(torch.ones((1, 1), dtype=self.logscale.dtype,
                                           device=self.logscale.device), None)
        return loss_so3 + 0.02 * torch.mean(inc ** 2)
