"""Pixel registration features, the DINOv2 slot
(`vidu4d_tpu/preprocess/features.py`).

The on-disk contract and post-processing are the reference's (PCA to 16
channels, L2 normalisation, masking, fp16 at 112 x 112), over one of two
backbones: the shipped FeatNet (`preprocess/featnet.py`) when its weights
exist, else a multi-scale histogram-of-gradients + colour descriptor. The
PCA (`pca_project`) stays in numpy with ``default_rng(0)``, as in JAX.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vidu4d_tpu_torch.preprocess.flow import _blur, _downsample, _to_gray
from vidu4d_tpu_torch.preprocess.ops import resize, resize_hwc

# frames per FeatNet call
FEATNET_CHUNK = 16


def _hog_cells(img: torch.Tensor, n_bins: int = 8) -> torch.Tensor:
    """Per-pixel orientation histograms of img (H, W, 3), blurred 3 times
    (soft HOG): (H, W, n_bins)."""
    gy, gx = torch.gradient(_to_gray(img))
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    bins = (torch.atan2(gy, gx) + math.pi) / (2 * math.pi) * n_bins
    lo = torch.remainder(torch.floor(bins).long(), n_bins)
    hi = (lo + 1) % n_bins
    w_hi = bins - torch.floor(bins)
    hist = (F.one_hot(lo, n_bins) * (mag * (1 - w_hi))[..., None]
            + F.one_hot(hi, n_bins) * (mag * w_hi)[..., None]).movedim(-1, 0)
    for _ in range(3):
        hist = _blur(hist)
    return hist.movedim(0, -1)


def hog_color_features(img: torch.Tensor, out_res: int = 112) -> torch.Tensor:
    """Multi-scale HOG + blurred colour descriptor of img (H, W, 3):
    (out_res, out_res, 33) (`features.py:51`)."""
    feats = []
    scale_img = img.float()
    for _ in range(3):
        h = _hog_cells(scale_img)
        c = _blur(scale_img.movedim(-1, 0)).movedim(0, -1)
        feats.append(resize_hwc(torch.cat([h, c], dim=-1), (out_res, out_res)))
        scale_img = _downsample(scale_img.movedim(-1, 0)).movedim(0, -1)
    return torch.cat(feats, dim=-1)


@functools.lru_cache(maxsize=4)
def _cached_featnet(path: str, device: str):
    from vidu4d_tpu_torch.preprocess.featnet import load_featnet

    return load_featnet(path, device)


def _featnet_backend(device):
    """The shipped FeatNet on ``device``, loaded once per file and device;
    None without a weights file or with ``VIDU4D_FEAT_BACKEND=hog``."""
    from vidu4d_tpu_torch.preprocess.featnet import WEIGHTS_ENV, WEIGHTS_FILE
    from vidu4d_tpu_torch.preprocess.layers import weights_path

    if os.environ.get("VIDU4D_FEAT_BACKEND", "") == "hog":
        return None
    return _cached_featnet(weights_path(WEIGHTS_ENV, WEIGHTS_FILE), str(torch.device(device)))


@torch.no_grad()
def backbone_features(frames: torch.Tensor, model=None, out_res: int = 112,
                      chunk: int = FEATNET_CHUNK) -> torch.Tensor:
    """(T, out_res, out_res, D) features of frames (T, H, W, 3): FeatNet's
    at half resolution resized bilinearly, or (``model`` None) the HOG +
    colour descriptor."""
    if model is None:
        return torch.stack([hog_color_features(f, out_res=out_res) for f in frames])
    out = []
    for s in range(0, frames.shape[0], chunk):
        d = model(frames[s:s + chunk].permute(0, 3, 1, 2).float())
        out.append(resize(d, (out_res, out_res)).permute(0, 2, 3, 1))
    return torch.cat(out)


def _mask_grid(masks: np.ndarray, out_res: int) -> np.ndarray:
    """Masks (T, H, W) at (out_res, out_res), nearest, as booleans."""
    m = resize(torch.as_tensor(np.asarray(masks, np.float32)), (out_res, out_res), "nearest")
    return m.numpy() > 0.5


def pca_project(feats: np.ndarray, masks: Optional[np.ndarray] = None,
                n_components: int = 16) -> np.ndarray:
    """PCA to ``n_components`` channels, L2 normalisation and masking of
    backbone features (T, R, R, D) (`features.py:117-150`): the basis is
    fit on up to 100k of the masked pixels drawn by ``default_rng(0)``
    (all pixels when the masks hold too few), masks (T, H, W) resized to
    R x R by nearest. Returns (T, R, R, n_components) float16."""
    feats = np.asarray(feats)
    out_res = feats.shape[1]
    rng = np.random.default_rng(0)
    flat = feats.reshape(-1, feats.shape[-1])
    m = _mask_grid(masks, out_res) if masks is not None else None
    candidates = flat
    if m is not None and m.sum() > n_components * 4:
        candidates = flat[m.reshape(-1)]
    sample = candidates[rng.permutation(len(candidates))[: 100 * 1000]]
    mean = sample.mean(0)
    _, _, vt = np.linalg.svd(sample - mean, full_matrices=False)
    proj = (flat - mean) @ vt[:n_components].T
    proj /= np.maximum(np.linalg.norm(proj, axis=-1, keepdims=True), 1e-12)
    out = proj.reshape(feats.shape[:-1] + (n_components,))
    if m is not None:
        out = out * m[..., None]
    return out.astype(np.float16)


def extract_video_features(frames: np.ndarray, masks: Optional[np.ndarray] = None,
                           out_res: int = 112, n_components: int = 16,
                           backbone: str = "auto", device="cuda",
                           stats: Optional[dict] = None) -> np.ndarray:
    """Per-frame features of frames (T, H, W, 3) in [0, 1] with PCA-16, L2
    norm and masking (`features.py:98`). Returns (T, out_res, out_res, 16)
    float16. ``stats``, when given, gets the backbone ("featnet" or "hog")
    and the seconds of the backbone and of the PCA."""
    if backbone not in ("auto", "featnet", "hog"):
        raise NotImplementedError("vit backbone requires local weights; use backbone='hog'")
    model = _featnet_backend(device) if backbone in ("auto", "featnet") else None
    if backbone == "featnet" and model is None:
        raise NotImplementedError("featnet backbone requires trained weights")
    t0 = time.perf_counter()
    x = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    feats = backbone_features(x, model, out_res).cpu().numpy()
    t1 = time.perf_counter()
    out = pca_project(feats, masks, n_components)
    if stats is not None:
        stats["features"] = "featnet" if model is not None else "hog"
        stats["features_net_s"] = t1 - t0
        stats["features_pca_s"] = time.perf_counter() - t1
    return out
