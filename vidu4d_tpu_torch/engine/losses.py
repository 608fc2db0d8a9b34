"""Loss helpers of the Stage-3 step (`vidu4d_tpu/engine/losses.py`)."""

from __future__ import annotations

import torch


def get_mask_balance_wt(mask, vis2d, is_detected):
    """Balance positive/negative mask pixels (`losses.py:28`)."""
    mask = mask.float()
    vis2d = vis2d.float() * is_detected.float().reshape((-1,) + (1,) * (mask.dim() - 1))
    pos_px = torch.sum(mask * (vis2d > 0))
    neg_px = torch.sum((1 - mask) * (vis2d > 0))
    total = torch.sum(vis2d)
    pos_wt = total / torch.clamp(pos_px, min=1e-6)
    neg_wt = total / torch.clamp(neg_px, min=1e-6)
    balanced = 0.5 * pos_wt * mask + 0.5 * neg_wt * (1 - mask)
    usable = (torch.sum(mask) > 0) & (torch.sum(1 - mask) > 0)
    return torch.where(usable, balanced, torch.ones_like(balanced))


def nonzero_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over strictly-positive entries; plain mean if none."""
    pos = (v > 0).to(v.dtype)
    cnt = torch.sum(pos)
    return torch.where(cnt > 0, torch.sum(v * pos) / torch.clamp(cnt, min=1.0),
                       torch.mean(v))
