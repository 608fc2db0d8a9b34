"""Monocular depth priors (`vidu4d_tpu/preprocess/depth.py`).

``auto`` takes the shipped DepthNet (`preprocess/depthnet.py`) when its
weights exist, else ``flow_parallax``: depth inverse to the median-
normalised LK flow magnitude of adjacent frames.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vidu4d_tpu_torch.preprocess.flow import lk_flow

# frames per DepthNet call (each frame is normalised on its own)
DEPTHNET_CHUNK = 16


def median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as ``jnp.median`` takes it: the mean of
    the two middle values for an even count (``torch.median`` takes the
    lower one)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def depth_from_flow_parallax(frames: torch.Tensor, base_depth: float = 2.0,
                             levels: int = 4) -> torch.Tensor:
    """(T, H, W) pseudo-depth from frames (T, H, W, 3) (`depth.py:28`)."""
    t = frames.shape[0]
    flow = torch.stack([lk_flow(a, b, levels=levels) for a, b in zip(frames[:-1], frames[1:])])
    mag = torch.sqrt(torch.sum(flow * flow, dim=-1) + 1e-12)
    mag = torch.cat([mag, mag[-1:]], dim=0)
    med = median_last(mag.reshape(t, -1))[:, None, None]
    rel = mag / torch.clamp(med, min=1e-6)
    return base_depth / torch.clamp(rel, 0.3, 3.0)


@functools.lru_cache(maxsize=4)
def _cached_depthnet(path: str, device: str):
    from vidu4d_tpu_torch.preprocess.depthnet import load_depthnet

    return load_depthnet(path, device)


def _depthnet_backend(device):
    """The shipped DepthNet on ``device``, loaded once per file and device;
    None without a weights file or with
    ``VIDU4D_DEPTH_BACKEND=flow_parallax``."""
    from vidu4d_tpu_torch.preprocess.depthnet import WEIGHTS_ENV, WEIGHTS_FILE
    from vidu4d_tpu_torch.preprocess.layers import weights_path

    if os.environ.get("VIDU4D_DEPTH_BACKEND", "") == "flow_parallax":
        return None
    return _cached_depthnet(weights_path(WEIGHTS_ENV, WEIGHTS_FILE), str(torch.device(device)))


@torch.no_grad()
def depth_from_net(frames: torch.Tensor, model, chunk: int = DEPTHNET_CHUNK) -> torch.Tensor:
    """(T, H, W[, 3]) frames -> (T, H, W) depth in [0.5, 4] through the
    DepthNet (`depth.py:83`): edge-padded to multiples of 16, ``chunk``
    frames per call."""
    from vidu4d_tpu_torch.preprocess.depthnet import disparity_to_depth

    if frames.ndim == 3:
        frames = frames[..., None].expand(-1, -1, -1, 3)
    t, h, w = frames.shape[:3]
    x = F.pad(frames.permute(0, 3, 1, 2), (0, (-w) % 16, 0, (-h) % 16), mode="replicate")
    disp = torch.cat([model(x[s:s + chunk]) for s in range(0, t, chunk)])[:, :h, :w]
    return disparity_to_depth(disp)


def estimate_depth(frames: np.ndarray, backend: str = "auto", device="cuda",
                   stats: Optional[dict] = None) -> np.ndarray:
    """(T, H, W) float16 depth of frames (T, H, W, 3) (`depth.py:99`).
    ``stats``, when given, gets the backend taken ("depthnet" or
    "flow_parallax")."""
    x = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    if backend == "auto":
        model = _depthnet_backend(device)
        if model is not None:
            if stats is not None:
                stats["depth"] = "depthnet"
            return depth_from_net(x, model).cpu().numpy().astype(np.float16)
        backend = "flow_parallax"
    if backend == "flow_parallax":
        if stats is not None:
            stats["depth"] = "flow_parallax"
        return depth_from_flow_parallax(x).cpu().numpy().astype(np.float16)
    raise NotImplementedError(f"depth backend {backend!r} needs local weights")
