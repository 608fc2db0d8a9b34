"""Time-conditioned MLPs: camera pose, intrinsics, appearance code, and the
prior fitting of `mlp_init` (`vidu4d_tpu/models/fields/time_mlp.py`).

A ``frame_id`` of None means every mapped frame (``frame_mapping``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.engine.optim import adam_step_
from vidu4d_tpu_torch.models.fields.embeddings import TimeEmbedding, adjusted_num_freq_t
from vidu4d_tpu_torch.models.fields.mlp import BaseMLP
from vidu4d_tpu_torch.ops.numerics import safe_norm, safe_normalize
from vidu4d_tpu_torch.ops.quaternion import (
    matrix_to_quaternion,
    quaternion_mul,
    quaternion_translation_to_se3,
)


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

    def frames(self, frame_id):
        return self.time_embedding.frame_mapping if frame_id is None else frame_id

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

    def forward(self, frame_id=None):
        """Returns (quat (..., 4), trans (..., 3)) field-to-camera."""
        frame_id = self.time_mlp.frames(frame_id)
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

    def forward(self, frame_id=None) -> torch.Tensor:
        """Returns (..., 4) intrinsics (fx, fy, cx, cy)."""
        frame_id = self.time_mlp.frames(frame_id)
        feat = self.time_mlp(frame_id)
        vid = self.time_mlp.vid_of(frame_id)
        focal = torch.exp(self.focal_head(feat)) * torch.exp(self.base_logfocal[vid])
        focal = (focal + focal.flip(-1)) / 2.0
        return torch.cat([focal, self.base_ppoint[vid]], dim=-1)


class AppearanceEmbedding(nn.Module):
    """Global appearance code over time (`time_mlp.py:151`)."""

    def __init__(self, frame_info: FrameInfo, appr_channels: int = 32, depth: int = 2,
                 width: int = 64, num_freq_t: int = 6, time_scale: float = 0.1,
                 device=None):
        super().__init__()
        self.time_mlp = TimeMLPTrunk(frame_info, depth, width, num_freq_t,
                                     time_scale=time_scale, device=device)
        self.output = nn.Linear(width, appr_channels, device=device)

    def forward(self, frame_id=None) -> torch.Tensor:
        return self.output(self.time_mlp(self.time_mlp.frames(frame_id)))


def camera_prior_loss(module: CameraMLP, rtmat_gt: torch.Tensor) -> torch.Tensor:
    """MSE between the predicted SE(3) of every mapped frame (as 4 x 4) and
    the priors (`time_mlp.py:177`)."""
    quat, trans = module()
    return torch.mean((quaternion_translation_to_se3(quat, trans) - rtmat_gt) ** 2)


def intrinsics_prior_loss(module: IntrinsicsMLP, intrinsics_gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((module() - intrinsics_gt) ** 2)


@torch.no_grad()
def init_camera_base_params(camera_mlp: CameraMLP, rtmat: np.ndarray,
                            frame_info: FrameInfo) -> None:
    """Set the per-video base quaternions from the first frame of each video
    of (N_frames, 4, 4) priors, in place (`time_mlp.py:189`)."""
    first = np.asarray(frame_info.frame_offset[:-1])
    rot = torch.as_tensor(np.asarray(rtmat)[first, :3, :3], dtype=torch.float32,
                          device=camera_mlp.base_quat.device)
    camera_mlp.base_quat.copy_(matrix_to_quaternion(rot))


def fit_to_prior(loss_fn: Callable[[], torch.Tensor], params: Iterable[torch.Tensor],
                 lr: float = 1e-3, termination_loss: float = 1e-4,
                 max_steps: int = 5000) -> Tuple[float, int]:
    """Fit ``params`` (in place) to a prior: Adam (`adam_step_`) while the
    loss before the step is above
    ``termination_loss`` and fewer than ``max_steps`` steps were taken
    (`time_mlp.py:210`, one `lax.while_loop` there). Each step reads its
    loss on the host. Returns (the last step's loss, steps)."""
    params = list(params)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    loss, steps = float("inf"), 0
    while loss > termination_loss and steps < max_steps:
        value = loss_fn()
        grads = torch.autograd.grad(value, params, allow_unused=True)
        steps += 1
        adam_step_(params, grads, mu, nu, steps, lr)
        loss = float(value.detach())
    return loss, steps


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
