"""Fourier / time / instance embeddings (`vidu4d_tpu/models/fields/embeddings.py`)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo


def pos_embed(x: torch.Tensor, n_freqs: int, alpha: Optional[float] = None) -> torch.Tensor:
    """Fourier embedding [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] grouped as
    (freq, func, channel); -1 disables (0 channels), 0 returns x. ``alpha``
    in [0, 1] applies the coarse-to-fine window
    w_j = 0.5 (1 + cos(pi + pi clip(alpha n - j, 0, 1))) to band j."""
    if n_freqs == -1:
        return x[..., :0]
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, None, :] * freqs[:, None, None]  # (..., F, 1, C)
    bands = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, C)
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        j = torch.arange(n_freqs, dtype=x.dtype, device=x.device)
        window = torch.clamp(a * n_freqs - j, 0.0, 1.0)
        window = 0.5 * (1.0 + torch.cos(math.pi * window + math.pi))
        bands = bands * window[:, None, None]
    return torch.cat([x, bands.reshape(x.shape[:-1] + (-1,))], dim=-1)


def adjusted_num_freq_t(frame_info: FrameInfo, num_freq_t: int) -> int:
    """Video-length-aware frequency count: num_frames=64 -> num_freq_t."""
    if num_freq_t <= 0:
        return num_freq_t
    max_ts = frame_info.max_vid_len
    return int(np.rint(math.log2(max(max_ts, 1) / 64) + num_freq_t))


class InstEmbedding(nn.Module):
    """Learnable per-instance code with the instance-swap regulariser
    (`embeddings.py:57`): with ``beta_prob`` > 0 and ``swap`` = (random ids
    in [0, num_inst), uniforms in [0, 1)), each of inst_id's shape, an id
    is replaced by its random id where its uniform is below ``beta_prob``.
    No caller passes ``beta_prob`` > 0 (the JAX package computes it in
    `progress_schedule` and passes it to no module), so the swap is inert
    on every path, as in JAX."""

    def __init__(self, num_inst: int, inst_channels: int, device=None):
        super().__init__()
        self.num_inst = num_inst
        self.mapping = nn.Parameter(
            torch.randn(num_inst, inst_channels, device=device))

    def forward(self, inst_id: torch.Tensor, beta_prob: float = 0.0,
                swap: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        if self.num_inst == 1:
            inst_id = torch.zeros_like(inst_id)
        elif beta_prob > 0.0 and swap is not None:
            rand_id, u = swap
            inst_id = torch.where(u < beta_prob, rand_id, inst_id)
        return self.mapping[inst_id.long()]

    def mean_embedding(self) -> torch.Tensor:
        return self.mapping.mean(dim=0)


class TimeEmbedding(nn.Module):
    """Per-frame embedding: normalized in-video time -> Fourier -> linear,
    concat per-video code -> linear (`embeddings.py:88`)."""

    def __init__(self, num_freq_t: int, frame_info: FrameInfo,
                 out_channels: int = 128, time_scale: float = 1.0, device=None):
        super().__init__()
        self.num_freq_t = num_freq_t
        self.time_scale = time_scale
        self.inst_embedding = InstEmbedding(frame_info.num_vids, out_channels,
                                            device=device)
        in_ch = 1 if num_freq_t <= 0 else 2 * num_freq_t + 1
        self.mapping1 = nn.Linear(in_ch, out_channels, device=device)
        self.mapping2 = nn.Linear(2 * out_channels, out_channels, device=device)

        off_raw = np.asarray(frame_info.frame_offset_raw)
        vid = frame_info.raw_fid_to_vid()
        buf = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        self.register_buffer("raw_fid_to_vid", buf(vid, torch.int64), persistent=False)
        self.register_buffer("raw_fid_to_vstart", buf(off_raw[vid], torch.float32),
                             persistent=False)
        self.register_buffer("raw_fid_to_vidlen",
                             buf(off_raw[vid + 1] - off_raw[vid], torch.float32),
                             persistent=False)
        self.register_buffer("frame_mapping", buf(frame_info.frame_mapping, torch.int64),
                             persistent=False)
        self.max_ts = float((off_raw[1:] - off_raw[:-1]).max())

    def frame_to_tid(self, frame_id: torch.Tensor) -> torch.Tensor:
        frame_id = frame_id.long()
        vid_len = self.raw_fid_to_vidlen[frame_id]
        tid_sub = frame_id.float() - self.raw_fid_to_vstart[frame_id]
        tid = (tid_sub - vid_len / 2.0) / self.max_ts * 2.0
        return tid * self.time_scale

    def forward(self, frame_id: torch.Tensor) -> torch.Tensor:
        """frame_id (...,) raw frame ids -> (..., C)."""
        inst_id = self.raw_fid_to_vid[frame_id.long()]
        coeff = pos_embed(self.frame_to_tid(frame_id)[..., None], self.num_freq_t)
        t_embed = torch.cat([self.mapping1(coeff), self.inst_embedding(inst_id)], -1)
        return self.mapping2(t_embed)

    def mean_embedding(self) -> torch.Tensor:
        """Mean time embedding over all mapped frames, (1, C)."""
        return self(self.frame_mapping).mean(dim=0, keepdim=True)
