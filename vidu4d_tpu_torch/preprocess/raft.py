"""RAFT-small optical flow (`vidu4d_tpu/preprocess/raft.py`), its training
loss (`sequence_loss`) and its weights file.

Feature and context encoders at 1/8 resolution, a 4-level all-pairs
correlation pyramid with radius-3 lookup, and a ConvGRU update iterated 12
times (unrolled, the flow detached before each lookup). Layout NCHW; the
weights are the shipped flax ones (`load_raft`), written back by
`save_weights`.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidu4d_tpu_torch.convert import flax_conv_net_flat
from vidu4d_tpu_torch.utils.io import savez_atomic
from vidu4d_tpu_torch.preprocess.layers import SameConv2d, group_norm, load_net, weights_path
from vidu4d_tpu_torch.preprocess.ops import pixel_grid, resize_hwc

HDIM = 96  # GRU hidden
CDIM = 64  # context
FDIM = 128  # matching feature dim
CORR_LEVELS = 4
CORR_RADIUS = 3
ITERS = 12
WEIGHTS_ENV, WEIGHTS_FILE = "VIDU4D_RAFT_NPZ", "raft_small_synthetic.npz"


class ResBlock(nn.Module):
    FLAX_NAMES = {"Conv_0": "conv1", "GroupNorm_0": "norm1", "Conv_1": "conv2",
                  "GroupNorm_1": "norm2", "Conv_2": "down"}

    def __init__(self, cin: int, ch: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = SameConv2d(cin, ch, 3, stride, device=device)
        self.norm1 = group_norm(ch, device=device)
        self.conv2 = SameConv2d(ch, ch, 3, device=device)
        self.norm2 = group_norm(ch, device=device)
        self.down = (SameConv2d(cin, ch, 1, stride, device=device)
                     if stride != 1 or cin != ch else None)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """1/8-resolution encoder (fnet and cnet share this trunk shape)."""

    FLAX_NAMES = {"Conv_0": "conv1", "GroupNorm_0": "norm1", "ResBlock_0": "layer1",
                  "ResBlock_1": "layer2", "ResBlock_2": "layer3", "Conv_1": "out"}

    def __init__(self, out_dim: int, device=None):
        super().__init__()
        self.conv1 = SameConv2d(3, 32, 7, 2, device=device)  # 1/2
        self.norm1 = group_norm(32, device=device)
        self.layer1 = ResBlock(32, 32, device=device)
        self.layer2 = ResBlock(32, 64, 2, device=device)  # 1/4
        self.layer3 = ResBlock(64, 96, 2, device=device)  # 1/8
        self.out = SameConv2d(96, out_dim, 1, device=device)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.out(self.layer3(self.layer2(self.layer1(x))))


def build_corr_pyramid(f1: torch.Tensor, f2: torch.Tensor):
    """All-pairs correlation of (N, C, H, W) features, /sqrt(C), as
    CORR_LEVELS levels (N, H*W, H_l, W_l), each a 2x2 average pool of the
    last (`raft.py:74`); a level below 1 x 1 is empty, as flax's pool
    makes it (a 1/8 grid of 6 rows at 48 x 64)."""
    n, c, h, w = f1.shape
    corr = torch.bmm(f1.flatten(2).transpose(1, 2), f2.flatten(2))
    corr = corr.div_(math.sqrt(c)).reshape(n, h * w, h, w)
    pyr = [corr]
    for _ in range(CORR_LEVELS - 1):
        prev = pyr[-1]
        hl, wl = prev.shape[2] // 2, prev.shape[3] // 2
        pyr.append(F.avg_pool2d(prev, 2) if hl and wl else prev.new_zeros(n, h * w, hl, wl))
    return pyr


def lookup_corr(pyr, coords: torch.Tensor) -> torch.Tensor:
    """Sample each level in a (2r+1)^2 window around coords (N, H, W, 2)
    (x, y at 1/8 resolution), bilinearly from the floor / clamped taps
    (`raft.py:86-127`). Returns (N, CORR_LEVELS * (2r+1)^2, H, W), levels
    outer, window row (dy) then column (dx) inner. An empty level reads 0,
    as JAX's gather from an empty axis does."""
    n, h, w, _ = coords.shape
    d = torch.arange(-CORR_RADIUS, CORR_RADIUS + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], dim=-1).reshape(-1, 2)
    out = []
    for lvl, corr in enumerate(pyr):
        c = coords.reshape(n, h * w, 1, 2) / (2.0 ** lvl) + delta
        hl, wl = corr.shape[2], corr.shape[3]
        if hl * wl == 0:
            out.append(c.new_zeros(c.shape[:-1]))
            continue
        x = torch.clamp(c[..., 0], 0.0, wl - 1.0)
        y = torch.clamp(c[..., 1], 0.0, hl - 1.0)
        x0, y0 = torch.floor(x), torch.floor(y)
        x1 = torch.clamp(x0 + 1, max=wl - 1.0)
        y1 = torch.clamp(y0 + 1, max=hl - 1.0)
        wx, wy = x - x0, y - y0
        flat = corr.reshape(n, h * w, hl * wl)

        def tap(xi, yi):
            return torch.gather(flat, 2, (yi * wl + xi).long())

        out.append(tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x1, y0) * wx * (1 - wy)
                   + tap(x0, y1) * (1 - wx) * wy + tap(x1, y1) * wx * wy)
    return torch.cat(out, dim=-1).reshape(n, h, w, -1).permute(0, 3, 1, 2)


class ConvGRU(nn.Module):
    FLAX_NAMES = {"Conv_0": "convz", "Conv_1": "convr", "Conv_2": "convq"}

    def __init__(self, hidden: int = HDIM, cin: int = CDIM + 82, device=None):
        super().__init__()
        self.convz = SameConv2d(hidden + cin, hidden, 3, device=device)
        self.convr = SameConv2d(hidden + cin, hidden, 3, device=device)
        self.convq = SameConv2d(hidden + cin, hidden, 3, device=device)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class MotionEncoder(nn.Module):
    FLAX_NAMES = {"Conv_0": "convc1", "Conv_1": "convc2", "Conv_2": "convf1",
                  "Conv_3": "convf2", "Conv_4": "conv"}

    def __init__(self, device=None):
        super().__init__()
        k = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = SameConv2d(k, 96, 1, device=device)
        self.convc2 = SameConv2d(96, 64, 3, device=device)
        self.convf1 = SameConv2d(2, 64, 7, device=device)
        self.convf2 = SameConv2d(64, 32, 3, device=device)
        self.conv = SameConv2d(96, 80, 3, device=device)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class UpdateBlock(nn.Module):
    FLAX_NAMES = {"MotionEncoder_0": "encoder", "ConvGRU_0": "gru", "Conv_0": "head1",
                  "Conv_1": "head2"}

    def __init__(self, device=None):
        super().__init__()
        self.encoder = MotionEncoder(device=device)
        self.gru = ConvGRU(device=device)
        self.head1 = SameConv2d(HDIM, 128, 3, device=device)
        self.head2 = SameConv2d(128, 2, 3, device=device)

    def forward(self, h, ctx, corr, flow):
        m = self.encoder(flow, corr)
        h = self.gru(h, torch.cat([ctx, m], dim=1))
        return h, self.head2(F.relu(self.head1(h)))


class RaftSmall(nn.Module):
    FLAX_NAMES = {"UpdateBlock_0": "update"}

    def __init__(self, iters: int = ITERS, device=None):
        super().__init__()
        self.iters = iters
        self.fnet = Encoder(FDIM, device=device)
        self.cnet = Encoder(HDIM + CDIM, device=device)
        self.update = UpdateBlock(device=device)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                all_iters: bool = False):
        """img1 / img2: (N, 3, H, W) in [0, 1], H and W multiples of 8.
        Returns the flow (N, H, W, 2) in pixels at full resolution; with
        ``all_iters`` the list of every iteration's."""
        feats = self.fnet(torch.cat([img1, img2], dim=0) * 2 - 1)
        f1, f2 = feats.chunk(2, dim=0)
        cnet = self.cnet(img1 * 2 - 1)
        h = torch.tanh(cnet[:, :HDIM])
        ctx = F.relu(cnet[:, HDIM:])

        pyr = build_corr_pyramid(f1, f2)
        n, _, hh, ww = f1.shape
        gx, gy = pixel_grid(hh, ww, f1.device)
        grid = torch.stack([gx, gy], dim=-1)[None]
        flow = torch.zeros((n, hh, ww, 2), dtype=torch.float32, device=f1.device)
        preds = []
        for _ in range(self.iters):
            flow = flow.detach()
            corr = lookup_corr(pyr, grid + flow)
            h, delta = self.update(h, ctx, corr, flow.permute(0, 3, 1, 2))
            flow = flow + delta.permute(0, 2, 3, 1)
            if all_iters:
                preds.append(self._upsample(flow))
        return preds if all_iters else self._upsample(flow)

    @staticmethod
    def _upsample(flow: torch.Tensor) -> torch.Tensor:
        """x8 bilinear (half-pixel centres) of (N, h, w, 2) flow in pixels."""
        return resize_hwc(flow * 8.0, (flow.shape[1] * 8, flow.shape[2] * 8))


def sequence_loss(preds: List[torch.Tensor], gt: torch.Tensor,
                  gamma: float = 0.8) -> Tuple[torch.Tensor, torch.Tensor]:
    """RAFT's training loss (`scripts/train_raft.py:127-137`) over the flows
    of every iteration (`RaftSmall(..., all_iters=True)`, each (N, H, W,
    2)): sum_i gamma^(n-1-i) mean |pred_i - gt|, and the last iteration's
    mean end-point error."""
    total = 0.0
    for i, fl in enumerate(preds):
        total = total + gamma ** (len(preds) - i - 1) * torch.mean(torch.abs(fl - gt))
    epe = torch.mean(torch.linalg.vector_norm(preds[-1] - gt, dim=-1))
    return total, epe


def save_weights(model: RaftSmall, path: str) -> None:
    """``model``'s weights as the shipped ``raft_small_synthetic.npz`` holds
    them (`raft.py:232`): flax keys without a prefix, ``np.savez_compressed``'s
    bytes, written to a temporary file and moved into place (a killed run
    never leaves a truncated npz); the directory is created."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    savez_atomic(path, flax_conv_net_flat(model), compressed=True)


def load_raft(path: Optional[str] = None, device="cuda") -> Optional[RaftSmall]:
    """RaftSmall with the shipped weights (``$VIDU4D_RAFT_NPZ`` or
    ``vidu4d_tpu/weights/raft_small_synthetic.npz``) on ``device``; None
    when the file does not exist."""
    return load_net(RaftSmall(), path or weights_path(WEIGHTS_ENV, WEIGHTS_FILE), device)
