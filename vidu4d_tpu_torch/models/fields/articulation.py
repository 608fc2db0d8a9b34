"""Bone articulation over time, bag of bones
(`vidu4d_tpu/models/fields/articulation.py`)."""

from __future__ import annotations

import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.time_mlp import Head, TimeMLPTrunk
from vidu4d_tpu_torch.ops.quaternion import (
    DualQuaternion,
    axis_angle_to_quaternion,
    quaternion_translation_to_dual_quaternion,
)


class ArticulationFlatMLP(nn.Module):
    """Free per-bone SE(3) over time: a time MLP with per-bone so3 and
    translation heads, as bone-to-object dual quaternions."""

    def __init__(self, frame_info: FrameInfo, num_se3: int = 25, depth: int = 5,
                 width: int = 256, num_freq_t: int = 6, device=None):
        super().__init__()
        self.num_se3 = num_se3
        # the reference shrinks the MLP for >= 50 bones (warping.py:357-360)
        d, w = (depth, width) if num_se3 < 50 else (2, 32)
        self.time_mlp = TimeMLPTrunk(frame_info, d, w, num_freq_t, device=device)
        self.trans_head = Head(w, 3 * num_se3, hidden=w // 2, device=device)
        self.so3_head = Head(w, 3 * num_se3, hidden=w // 2, device=device)

    def _heads_to_dq(self, t_feat: torch.Tensor) -> DualQuaternion:
        trans = 0.1 * self.trans_head(t_feat)
        so3 = self.so3_head(t_feat)
        shape = t_feat.shape[:-1] + (self.num_se3, 3)
        qr = axis_angle_to_quaternion(so3.reshape(shape))
        return quaternion_translation_to_dual_quaternion(qr, trans.reshape(shape))

    def forward(self, frame_id: torch.Tensor) -> DualQuaternion:
        """Bone-to-object transforms at frames: ((..., B, 4), (..., B, 4))."""
        return self._heads_to_dq(self.time_mlp(frame_id))

    def mean_vals(self) -> DualQuaternion:
        """Rest-shape bone-to-object transforms ((1, B, 4), (1, B, 4))."""
        return self._heads_to_dq(self.time_mlp.mean_feat())

    def vals_and_mean(self, frame_id: torch.Tensor):
        """(t_articulation, rest_articulation broadcast to match)."""
        pred_t = self(frame_id)
        mean = self.mean_vals()
        return pred_t, (mean[0].expand_as(pred_t[0]), mean[1].expand_as(pred_t[1]))
