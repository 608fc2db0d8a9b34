"""Flow-propagated video segmentation, the Track-Anything slot
(`vidu4d_tpu/preprocess/segment.py`).

The seed mask of frame 0 is an input (an annotation), or the motion seed
(`motion_seed_mask`: camera-compensated differencing, then an appearance
classifier), or the centre prior. Propagation warps the previous mask
forward with RAFT flow, adds the log-likelihood ratio of two EMA colour
histograms (fg / bg) and cleans up with a 3 x 3 majority vote, one frame
after another (`propagate_masks`).

The histograms are scatter-adds (``index_add_``): on CUDA the order of
the float additions varies between runs, so a card's masks can differ
from the CPU's at pixels whose logit is within rounding of 0.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vidu4d_tpu_torch.preprocess.ops import warp_by_flow

# per-channel colour quantisation: 8^3 = 512 bins (`segment.py:32`)
_BINS = 8


def _bin_ids(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (H, W) histogram bin."""
    q = torch.clamp((rgb * _BINS).long(), 0, _BINS - 1)
    return (q[..., 0] * _BINS + q[..., 1]) * _BINS + q[..., 2]


def _histogram(bins: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted (_BINS**3,) histogram of bins (H, W) (a scatter-add)."""
    flat = torch.zeros(_BINS ** 3, dtype=torch.float32, device=bins.device)
    return flat.index_add_(0, bins.reshape(-1), weights.reshape(-1).float())


def _box(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean of (H, W), zero padded to the same size
    (``convolve2d(..., mode="same")``, odd k)."""
    w = torch.full((1, 1, k, k), 1.0 / (k * k), dtype=x.dtype, device=x.device)
    return F.conv2d(x[None, None], w, padding=k // 2)[0, 0]


def _majority3(mask: torch.Tensor) -> torch.Tensor:
    """3 x 3 box majority vote of (H, W)."""
    return (_box(mask, 3) > 0.5).to(mask.dtype)


def _appearance_logit(bins, hist_fg, hist_bg) -> torch.Tensor:
    """log p(colour | fg) - log p(colour | bg), Laplace-smoothed."""
    p_fg = (hist_fg + 1.0) / (torch.sum(hist_fg) + _BINS ** 3)
    p_bg = (hist_bg + 1.0) / (torch.sum(hist_bg) + _BINS ** 3)
    return torch.log(p_fg)[bins] - torch.log(p_bg)[bins]


@torch.no_grad()
def propagate_masks(frames: torch.Tensor, seed_mask: torch.Tensor, flows_bw: torch.Tensor,
                    appearance_wt: float = 1.0, ema: float = 0.85) -> torch.Tensor:
    """Track seed_mask (H, W) of frame 0 through frames (T, H, W, 3) with
    flows_bw (T-1, H, W, 2) from frame t+1 back to t (`segment.py:69`).
    Returns (T, H, W) float32. Per frame: the previous mask warped and
    box-blurred (5 x 5) as a soft prior, plus the appearance logit,
    thresholded and majority-cleaned; then the histograms take the
    confident pixels."""
    seed = (torch.as_tensor(seed_mask, device=frames.device) > 0.5).float()
    bins0 = _bin_ids(frames[0])
    hist_fg = _histogram(bins0, seed)
    hist_bg = _histogram(bins0, 1.0 - seed)
    masks = [seed]
    for frame, flow_bw in zip(frames[1:], flows_bw):
        prior = warp_by_flow(masks[-1][..., None], flow_bw)[..., 0]
        prior = torch.clamp(_box(prior, 5), 0.08, 0.92)
        bins = _bin_ids(frame)
        logit = (torch.log(prior) - torch.log1p(-prior)
                 + appearance_wt * _appearance_logit(bins, hist_fg, hist_bg))
        mask = _majority3((logit > 0.0).float())
        conf_fg = mask * (prior > 0.6)
        conf_bg = (1.0 - mask) * (prior < 0.4)
        hist_fg = ema * hist_fg + (1 - ema) * _histogram(bins, conf_fg)
        hist_bg = ema * hist_bg + (1 - ema) * _histogram(bins, conf_bg)
        masks.append(mask)
    return torch.stack(masks)


def _fit_affine_flow(flow: np.ndarray, n_irls: int = 4):
    """Robust (IRLS) affine fit flow(x) ~= A [x, y, 1] of the dominant
    background motion (`segment.py:118`). Returns (residual magnitude
    (H, W), the affine flow field (H, W, 2))."""
    h, w = flow.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    basis = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w, np.float32)], 1)
    target = flow.reshape(-1, 2).astype(np.float64)
    wgt = np.ones((h * w,), np.float64)
    pred = np.zeros_like(target)
    for _ in range(n_irls):
        a, *_ = np.linalg.lstsq(basis * wgt[:, None], target * wgt[:, None], rcond=None)
        pred = basis @ a
        resid = np.linalg.norm(target - pred, axis=1)
        mad = np.median(np.abs(resid - np.median(resid))) + 1e-6
        wgt = 1.0 / (1.0 + (resid / (3.0 * 1.4826 * mad)) ** 2)
    return (resid.reshape(h, w).astype(np.float32),
            pred.reshape(h, w, 2).astype(np.float32))


def _np_warp(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Bilinear backward warp out(x) = img(x + flow(x)) of (H, W[, C])."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x = np.clip(xs + flow[..., 0], 0, w - 1.001)
    y = np.clip(ys + flow[..., 1], 0, h - 1.001)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    fx, fy = x - x0, y - y0
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def _refine_affine_flow(gray0: np.ndarray, grayd: np.ndarray, pred: np.ndarray,
                        iters: int = 30) -> np.ndarray:
    """Gauss-Newton photometric refinement (Cauchy-weighted, on 3 x 3
    smoothed greys) of the affine camera-motion field (`segment.py:164`)."""
    import scipy.ndimage as ndi

    h, w = gray0.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    basis = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w, np.float32)], 1)
    a, *_ = np.linalg.lstsq(basis, pred.reshape(-1, 2), rcond=None)
    f0s = ndi.uniform_filter(gray0, size=3)
    fds = ndi.uniform_filter(grayd, size=3)
    bm = np.zeros((h, w), np.float32)
    bm[4:-4, 4:-4] = 1
    for _ in range(iters):
        wimg = _np_warp(fds, (basis @ a).reshape(h, w, 2))
        r = (wimg - f0s) * bm
        gy, gx = np.gradient(wimg)
        jac = np.concatenate([gx.reshape(-1, 1) * basis, gy.reshape(-1, 1) * basis],
                             1) * bm.reshape(-1, 1)
        rr = np.abs(r.ravel())
        pos = rr[rr > 0]
        c = 3.0 * 1.4826 * (np.median(pos) if pos.size else 1e-3) + 1e-9
        jw = jac * (1.0 / (1.0 + (rr / c) ** 2))[:, None]
        try:
            da = np.linalg.solve(jw.T @ jac + 1e-4 * np.eye(6), jw.T @ r.ravel())
        except np.linalg.LinAlgError:
            break
        a = a - da.reshape(2, 3).T
        if np.abs(da).max() < 1e-6:
            break
    return (basis @ a).reshape(h, w, 2).astype(np.float32)


def _np_box3(x: np.ndarray) -> np.ndarray:
    return _box(torch.as_tensor(np.asarray(x, np.float32)), 3).numpy()


def _np_majority3(x: np.ndarray) -> np.ndarray:
    return _majority3(torch.as_tensor(np.asarray(x, np.float32))).numpy() > 0.5


def _largest_component(mask: np.ndarray) -> Optional[np.ndarray]:
    import scipy.ndimage as ndi

    labels, n = ndi.label(mask)
    if n == 0:
        return None
    return labels == 1 + np.argmax(ndi.sum_labels(mask, labels, range(1, n + 1)))


def motion_seed_mask(frames: np.ndarray, deltas: Tuple[int, ...] = (1, 2, 4, 8),
                     min_px: float = 0.04, z_core: float = 4.0,
                     area_bounds: Tuple[float, float] = (0.002, 0.6),
                     device="cuda") -> Optional[np.ndarray]:
    """Frame-0 seed (H, W) float32 from motion and appearance
    (`segment.py:213`), or None when the motion evidence is degenerate.

    1. Locate: per delta, the flow frame 0 -> delta (on ``device``), its
       robust affine background fit refined photometrically (the deltas
       in host threads), and the
       camera-compensated difference (or the raw one, where that has the
       lower median: a static camera); the median over deltas; its core
       above med + z_core * MAD and ``min_px``, majority-cleaned, largest
       component.
    2. Segment: colour histograms of the core vs far outside it, the
       likelihood ratio inside a dilated band, majority-cleaned, largest
       component, holes filled; None outside ``area_bounds``."""
    import scipy.ndimage as ndi

    from vidu4d_tpu_torch.preprocess.flow import compute_flow_pairs

    t, h, w = frames.shape[:3]
    frames = np.asarray(frames, np.float32)
    ds = [d for d in deltas if d < t]
    if not ds:
        return None
    flows = []
    for d in ds:  # on the device, one pair after another
        pair = torch.as_tensor(np.stack([frames[0], frames[d]]), device=device)
        flows.append(compute_flow_pairs(pair, 1)[0][0, ..., :2].cpu().numpy())

    def evidence(d, flow):
        """Motion evidence of delta d (host numpy, which releases the GIL
        in its large array operations: the deltas run in threads)."""
        f0, fd = frames[0], frames[d]
        flow_ref = _refine_affine_flow(f0.mean(-1), fd.mean(-1), _fit_affine_flow(flow)[1])
        # symmetric half-flow warp: both frames pay the same resampling blur
        d_warp = _np_box3(np.abs(_np_warp(fd, 0.5 * flow_ref)
                                 - _np_warp(f0, -0.5 * flow_ref)).mean(-1))
        d_raw = _np_box3(np.abs(fd - f0).mean(-1))
        return d_warp if np.median(d_warp) < np.median(d_raw) else d_raw

    with ThreadPoolExecutor(max_workers=len(ds)) as pool:
        diffs = list(pool.map(evidence, ds, flows))

    ev = np.median(np.stack(diffs), axis=0)
    med = np.median(ev)
    mad = 1.4826 * np.median(np.abs(ev - med)) + 1e-6
    core = _largest_component(_np_majority3((ev > med + z_core * mad) & (ev > min_px)))
    if core is None or core.sum() < max(12, area_bounds[0] * h * w):
        return None

    r_obj = np.sqrt(core.sum() / np.pi)  # equivalent-disk radius
    band = ndi.binary_dilation(core, iterations=max(int(0.75 * r_obj), 3))
    far_bg = ~ndi.binary_dilation(core, iterations=max(int(2 * r_obj), 6))
    if far_bg.sum() < 64:
        far_bg = ev <= med
    bins = _bin_ids(torch.as_tensor(frames[0]))
    logit = _appearance_logit(bins, _histogram(bins, torch.as_tensor(core)),
                              _histogram(bins, torch.as_tensor(far_bg))).numpy()
    seed = _largest_component(_np_majority3((logit > 0.0) & band))
    if seed is None:
        return None
    seed = ndi.binary_fill_holes(seed)
    if not (area_bounds[0] <= float(seed.mean()) <= area_bounds[1]):
        return None
    return seed.astype(np.float32)


def segment_video(frames: np.ndarray, seed_mask: Optional[np.ndarray] = None,
                  appearance_wt: float = 1.0, auto_seed: bool = False, device="cuda",
                  stats: Optional[dict] = None) -> np.ndarray:
    """(T, H, W, 3) frames -> (T, H, W) float32 masks (`segment.py:350`).
    The seed: ``seed_mask``, else with ``auto_seed`` the motion seed, else
    the centre prior. Flow: `compute_flow_pairs` on the raw frames.
    ``stats``, when given, gets the seed's source ("given", "motion" or
    "center") and the flow backend."""
    from vidu4d_tpu_torch.preprocess.flow import compute_flow_pairs
    from vidu4d_tpu_torch.preprocess.pipeline import center_box_mask

    source = "given"
    if seed_mask is None and auto_seed:
        seed_mask, source = motion_seed_mask(np.asarray(frames), device=device), "motion"
    if seed_mask is None:
        seed_mask, source = center_box_mask(frames.shape[1:3]), "center"
    if stats is not None:
        stats["seed"] = source
    x = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    flow_bw = compute_flow_pairs(x, 1, stats=stats)[1][..., :2]
    return propagate_masks(x, torch.as_tensor(np.asarray(seed_mask)), flow_bw,
                           appearance_wt=appearance_wt).cpu().numpy()
