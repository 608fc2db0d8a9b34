"""Time-conditioned MLPs: camera pose and intrinsics
(`vidu4d_tpu/models/fields/time_mlp.py`)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.embeddings import TimeEmbedding, adjusted_num_freq_t
from vidu4d_tpu_torch.models.fields.mlp import BaseMLP
from vidu4d_tpu_torch.ops.numerics import safe_norm, safe_normalize
from vidu4d_tpu_torch.ops.quaternion import quaternion_mul


class TimeMLPTrunk(nn.Module):
    """TimeEmbedding -> MLP(W -> W) trunk shared by time-conditioned heads."""

    def __init__(self, frame_info: FrameInfo, depth: int = 5, width: int = 256,
                 num_freq_t: int = 6, time_scale: float = 1.0, device=None):
        super().__init__()
        nft = adjusted_num_freq_t(frame_info, num_freq_t)
        self.time_embedding = TimeEmbedding(nft, frame_info, out_channels=width,
                                            time_scale=time_scale, device=device)
        self.trunk = BaseMLP(width, depth=depth, width=width, out_channels=width,
                             skips=(), final_act=True, device=device)

    def vid_of(self, frame_id: torch.Tensor) -> torch.Tensor:
        return self.time_embedding.raw_fid_to_vid[frame_id.long()]

    def forward(self, frame_id: torch.Tensor) -> torch.Tensor:
        return self.trunk(self.time_embedding(frame_id))

    def mean_feat(self) -> torch.Tensor:
        return self.trunk(self.time_embedding.mean_embedding())


class Head(nn.Module):
    """Two-layer head: W -> hidden -> out (`time_mlp.py:66`)."""

    def __init__(self, in_channels: int, out_channels: int, hidden: int = 128,
                 device=None):
        super().__init__()
        self.hidden = nn.Linear(in_channels, hidden, device=device)
        self.out = nn.Linear(hidden, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.hidden(x)))


class CameraMLP(nn.Module):
    """Object-to-camera SE(3) over time: per-video base quaternion composed
    with MLP quat/trans heads (`time_mlp.py:77`)."""

    def __init__(self, frame_info: FrameInfo, depth: int = 5, width: int = 256,
                 num_freq_t: int = 6, device=None):
        super().__init__()
        self.time_mlp = TimeMLPTrunk(frame_info, depth, width, num_freq_t,
                                     device=device)
        self.trans_head = Head(width, 3, hidden=width // 2, device=device)
        self.quat_head = Head(width, 4, hidden=width // 2, device=device)
        self.base_quat = nn.Parameter(torch.zeros(frame_info.num_vids, 4, device=device))

    def forward(self, frame_id: torch.Tensor):
        """Returns (quat (..., 4), trans (..., 3)) field-to-camera."""
        feat = self.time_mlp(frame_id)
        trans = self.trans_head(feat)
        quat = safe_normalize(self.quat_head(feat))
        bq = self.base_quat[self.time_mlp.vid_of(frame_id)]
        bq_norm = safe_norm(bq, dim=-1, keepdim=True)
        # zero-init base quats act as identity until set from priors
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=bq.dtype, device=bq.device)
        bq = torch.where(bq_norm > 1e-6, bq / bq_norm, ident.expand_as(bq))
        return quaternion_mul(quat, bq), trans


class IntrinsicsMLP(nn.Module):
    """Per-video base log-focal/ppoint modulated by an MLP focal factor;
    square pixels forced (`time_mlp.py:117`)."""

    def __init__(self, frame_info: FrameInfo, depth: int = 5, width: int = 256,
                 num_freq_t: int = 0, time_scale: float = 0.1, device=None):
        super().__init__()
        self.time_mlp = TimeMLPTrunk(frame_info, depth, width, num_freq_t,
                                     time_scale=time_scale, device=device)
        self.focal_head = Head(width, 2, hidden=width // 2, device=device)
        nv = frame_info.num_vids
        self.base_logfocal = nn.Parameter(torch.zeros(nv, 2, device=device))
        self.base_ppoint = nn.Parameter(torch.zeros(nv, 2, device=device))

    def forward(self, frame_id: torch.Tensor) -> torch.Tensor:
        """Returns (..., 4) intrinsics (fx, fy, cx, cy)."""
        feat = self.time_mlp(frame_id)
        vid = self.time_mlp.vid_of(frame_id)
        focal = torch.exp(self.focal_head(feat)) * torch.exp(self.base_logfocal[vid])
        focal = (focal + focal.flip(-1)) / 2.0
        return torch.cat([focal, self.base_ppoint[vid]], dim=-1)


@torch.no_grad()
def init_intrinsics_base_params(intrinsics_mlp: IntrinsicsMLP,
                                intrinsics: np.ndarray,
                                frame_info: FrameInfo) -> None:
    """Set per-video base focal/ppoint from (N_frames, 4) priors, in place
    (`time_mlp.py:200`)."""
    first = np.asarray(frame_info.frame_offset[:-1])
    k = torch.as_tensor(np.asarray(intrinsics)[first], dtype=torch.float32,
                        device=intrinsics_mlp.base_logfocal.device)
    intrinsics_mlp.base_logfocal.copy_(torch.log(k[:, :2]))
    intrinsics_mlp.base_ppoint.copy_(k[:, 2:])
