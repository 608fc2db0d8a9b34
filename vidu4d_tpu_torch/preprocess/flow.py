"""Dense optical flow for Stage 1 (`vidu4d_tpu/preprocess/flow.py`).

`compute_flow_pairs` is the entry point: the shipped RAFT-small
(`preprocess/raft.py`) when its weights exist and H, W are multiples of 8,
else a coarse-to-fine pyramidal Lucas-Kanade. The output contract is the
reference's: per pair (H, W, 3) = [flow_x, flow_y, occlusion], occlusion
from the forward-backward cycle check.

RAFT runs over the pairs in chunks sized to a memory budget (each pair is
independent: GroupNorm normalises per sample), since one pair's
correlation volume at 720 x 1280 is (90 * 160)^2 floats = 829 MB.

One divergence from JAX, on purpose: JAX falls back to LK when loading the
RAFT weights fails for any reason; here a weights file that exists but
does not load raises. LK is taken only when there is no weights file or
``VIDU4D_FLOW_BACKEND=lk``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vidu4d_tpu_torch.preprocess.ops import resize_hwc, warp_by_flow
from vidu4d_tpu_torch.preprocess.raft import CORR_LEVELS, load_raft

# bytes RAFT may hold for one chunk of pairs (`raft_chunk`)
RAFT_MEMORY_BUDGET = 6 << 30
GRAY = (0.299, 0.587, 0.114)


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    if img.ndim == 3 and img.shape[-1] == 3:
        return img @ torch.tensor(GRAY, dtype=img.dtype, device=img.device)
    return img[..., 0] if img.ndim == 3 else img


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur of (..., H, W), zero padded ("SAME")."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=img.dtype, device=img.device) / 16.0
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.conv2d(x, k.reshape(1, 1, 1, 5), padding=(0, 2))
    x = F.conv2d(x, k.reshape(1, 1, 5, 1), padding=(2, 0))
    return x.reshape(img.shape)


def _downsample(img: torch.Tensor) -> torch.Tensor:
    return _blur(img)[..., ::2, ::2]


def _gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d/dx, d/dy) of (H, W): central differences, one-sided at the edges
    (``jnp.gradient``)."""
    gy, gx = torch.gradient(img)
    return gx, gy


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Local sum over a (2r+1)^2 window of (H, W) by two cumsum passes."""
    k = 2 * radius + 1
    xp = F.pad(x, (radius + 1, radius, radius + 1, radius))
    c = torch.cumsum(torch.cumsum(xp, dim=0), dim=1)
    return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]


def _lk_refine(i0: torch.Tensor, i1: torch.Tensor, flow: torch.Tensor,
               radius: int = 4, iters: int = 3, eps: float = 1e-3) -> torch.Tensor:
    """``iters`` Lucas-Kanade updates of flow (H, W, 2) at one level."""
    gx, gy = _gradients(i0)
    ixx = _box_filter(gx * gx, radius)
    ixy = _box_filter(gx * gy, radius)
    iyy = _box_filter(gy * gy, radius)
    det = ixx * iyy - ixy * ixy
    det_safe = torch.where(torch.abs(det) < eps, eps, det)
    good = (torch.abs(det) > eps)[..., None]
    for _ in range(iters):
        it = warp_by_flow(i1[..., None], flow)[..., 0] - i0
        bx = _box_filter(gx * it, radius)
        by = _box_filter(gy * it, radius)
        du = -(iyy * bx - ixy * by) / det_safe
        dv = -(-ixy * bx + ixx * by) / det_safe
        delta = torch.clamp(torch.stack([du, dv], dim=-1), -radius, radius)
        flow = flow + torch.where(good, delta, 0.0)
    return flow


def lk_flow(img0: torch.Tensor, img1: torch.Tensor, levels: int = 4,
            radius: int = 4, iters: int = 3) -> torch.Tensor:
    """Dense flow img0 -> img1 (H, W, 3), (H, W, 2); H and W divisible by
    2^levels."""
    pyr0 = [_to_gray(img0.float())]
    pyr1 = [_to_gray(img1.float())]
    for _ in range(levels - 1):
        pyr0.append(_downsample(pyr0[-1]))
        pyr1.append(_downsample(pyr1[-1]))
    flow = torch.zeros(pyr0[-1].shape + (2,), dtype=torch.float32, device=img0.device)
    for lvl in reversed(range(levels)):
        if lvl < levels - 1:
            flow = resize_hwc(flow, pyr0[lvl].shape) * 2.0
        flow = _lk_refine(pyr0[lvl], pyr1[lvl], flow, radius=radius, iters=iters)
    return flow


def occlusion_from_cycle(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                         thresh_px: float = 1.5) -> torch.Tensor:
    """1 where the forward-backward cycle of flow (H, W, 2) misses by more
    than ``thresh_px``, else 0."""
    cyc = flow_fw + warp_by_flow(flow_bw, flow_fw)
    dis = torch.sqrt(torch.clamp(torch.sum(cyc * cyc, dim=-1), min=1e-24))
    return (dis > thresh_px).float()


@functools.lru_cache(maxsize=4)
def _cached_raft(path: str, device: str):
    return load_raft(path, device)


def _raft_backend(device):
    """The shipped RAFT-small on ``device`` (``$VIDU4D_RAFT_NPZ`` or
    ``vidu4d_tpu/weights/raft_small_synthetic.npz``), loaded once per file
    and device; None without a weights file or with
    ``VIDU4D_FLOW_BACKEND=lk``. A file that does not load raises."""
    from vidu4d_tpu_torch.preprocess.layers import weights_path
    from vidu4d_tpu_torch.preprocess.raft import WEIGHTS_ENV, WEIGHTS_FILE

    if os.environ.get("VIDU4D_FLOW_BACKEND", "") == "lk":
        return None
    return _cached_raft(weights_path(WEIGHTS_ENV, WEIGHTS_FILE), str(torch.device(device)))


def raft_chunk(h: int, w: int) -> int:
    """Pairs per RAFT call within RAFT_MEMORY_BUDGET bytes: one pair holds its
    correlation pyramid ((h/8 * w/8)^2 floats, x 4/3 over the levels) and
    the encoders' activations (3 images, ~256 bytes per pixel each)."""
    cells = (h // 8) * (w // 8)
    corr = cells * cells * 4 * sum(4.0 ** -k for k in range(CORR_LEVELS))
    return max(1, int(RAFT_MEMORY_BUDGET // (corr + 3 * 256 * h * w)))


@torch.no_grad()
def raft_flow(model, f0: torch.Tensor, f1: torch.Tensor, chunk: int) -> torch.Tensor:
    """RAFT flow of the pairs (f0[i], f1[i]) (N, H, W, 3), ``chunk`` pairs
    per call. Returns (N, H, W, 2)."""
    out = []
    for s in range(0, f0.shape[0], chunk):
        a = f0[s:s + chunk].permute(0, 3, 1, 2)
        b = f1[s:s + chunk].permute(0, 3, 1, 2)
        out.append(model(a, b))
    return torch.cat(out)


@torch.no_grad()
def compute_flow_pairs(frames: torch.Tensor, delta: int, levels: int = 4,
                       stats: Optional[dict] = None):
    """Flow of every (t, t + delta) pair of frames (T, H, W, 3) in [0, 1]
    (`flow.py:148`). Returns (flow_fw, flow_bw), each (T - delta, H, W, 3)
    [fx, fy, occ], on the frames' device. ``stats``, when given, gets the
    backend ("raft" or "lk") and RAFT's chunk of pairs."""
    frames = frames.float()
    t, h, w = frames.shape[:3]
    n = t - delta
    f0, f1 = frames[:n], frames[delta:delta + n]
    model = _raft_backend(frames.device)
    if model is not None and h % 8 == 0 and w % 8 == 0:
        chunk = raft_chunk(h, w)
        fw = raft_flow(model, f0, f1, chunk)
        bw = raft_flow(model, f1, f0, chunk)
        backend = "raft"
    else:
        fw = torch.stack([lk_flow(a, b, levels=levels) for a, b in zip(f0, f1)])
        bw = torch.stack([lk_flow(a, b, levels=levels) for a, b in zip(f1, f0)])
        backend, chunk = "lk", None
    if stats is not None:
        stats["flow"] = backend
        stats["raft_chunk"] = chunk
    occ_fw = torch.stack([occlusion_from_cycle(a, b) for a, b in zip(fw, bw)])
    occ_bw = torch.stack([occlusion_from_cycle(b, a) for a, b in zip(fw, bw)])
    return (torch.cat([fw, occ_fw[..., None]], dim=-1),
            torch.cat([bw, occ_bw[..., None]], dim=-1))
