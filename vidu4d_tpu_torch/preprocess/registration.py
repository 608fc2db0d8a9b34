"""Rough camera registration from flow and depth
(`vidu4d_tpu/preprocess/registration.py`): per-pair rigid motion by
(weighted) Procrustes on flow correspondences lifted with depth, chained
into scene-to-camera poses. Everything stays in float32 or float64: a
rotation of a few degrees lives in the small antisymmetric part of the
covariance, which reduced precision flattens.

The pipeline's pair loop is `two_frame_registration_np` (host float64
IRLS-Kabsch); `two_frame_registration` / `robust_procrustes` are the
device versions, the robust one drawing its hypotheses from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vidu4d_tpu_torch.preprocess.ops import pixel_grid, warp_by_flow


def weighted_procrustes(pts0: torch.Tensor, pts1: torch.Tensor,
                        weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """R, t minimising sum w ||R p0 + t - p1||^2 (weighted Kabsch;
    `registration.py:21`)."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-8)
    m0 = torch.sum(pts0 * w[:, None], dim=0)
    m1 = torch.sum(pts1 * w[:, None], dim=0)
    h = ((pts0 - m0) * w[:, None]).T @ (pts1 - m1)
    u, _, vt = torch.linalg.svd(h)
    d = torch.ones(3, dtype=h.dtype, device=h.device)
    d[2] = torch.linalg.det(vt.T @ u.T)
    r = vt.T @ torch.diag(d) @ u.T
    return r, m1 - r @ m0


def robust_procrustes(pts0, pts1, weights, generator: torch.Generator,
                      num_hypotheses: int = 64, min_samples: int = 10,
                      inlier_frac: float = 0.05):
    """Fixed-shape RANSAC (`registration.py:49`): ``num_hypotheses`` fits on
    ``min_samples`` points drawn by weight without replacement (Gumbel
    top-k, the noise from ``generator``), each scored by its weighted
    inliers; the best one's inliers (as weights) are refit."""
    n = pts0.shape[0]
    extent = torch.mean(pts0.amax(0) - pts0.amin(0))
    threshold = extent * inlier_frac
    u = torch.rand((num_hypotheses, n), generator=generator, device=pts0.device,
                   dtype=pts0.dtype)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    idx = torch.topk(gumbel + torch.log(torch.clamp(weights, min=1e-12)), min_samples,
                     dim=-1).indices
    best, best_inliers = None, None
    for sel in idx:
        r, t = weighted_procrustes(pts0[sel], pts1[sel],
                                   torch.ones(min_samples, dtype=pts0.dtype, device=pts0.device))
        resid = torch.sqrt(torch.clamp(torch.sum((pts0 @ r.T + t - pts1) ** 2, dim=-1),
                                       min=1e-24))
        inliers = (resid < threshold).to(weights.dtype) * weights
        score = torch.sum(inliers)
        if best is None or score > best:
            best, best_inliers = score, inliers
    return weighted_procrustes(pts0, pts1, best_inliers)


def two_frame_registration(depth0, depth1, flow, kinv0, kinv1, mask,
                           generator: Optional[torch.Generator] = None,
                           robust: bool = False) -> torch.Tensor:
    """Rigid cam0 -> cam1 (4, 4) from correspondences of flow (H, W, 2)
    lifted with depth (`registration.py:76`)."""
    h, w = depth0.shape
    gx, gy = pixel_grid(h, w, depth0.device)
    one = torch.ones_like(gx)
    hp0 = torch.stack([gx, gy, one], dim=-1).reshape(-1, 3)
    hp1 = torch.stack([gx + flow[..., 0], gy + flow[..., 1], one], dim=-1).reshape(-1, 3)
    d1w = warp_by_flow(depth1[..., None], flow)[..., 0].reshape(-1)
    pts0 = (hp0 @ kinv0.T) * depth0.reshape(-1, 1)
    pts1 = (hp1 @ kinv1.T) * d1w[:, None]
    weights = mask.reshape(-1).float() * (d1w > 0)
    if robust:
        if generator is None:
            raise ValueError("robust registration draws its hypotheses from a generator")
        r, t = robust_procrustes(pts0, pts1, weights, generator)
    else:
        r, t = weighted_procrustes(pts0, pts1, weights)
    rt = torch.eye(4, dtype=r.dtype, device=r.device)
    rt[:3, :3] = r
    rt[:3, 3] = t
    return rt


def chain_poses(pairwise: torch.Tensor) -> torch.Tensor:
    """Chain per-pair motions (N, 4, 4) into scene-to-camera poses
    (N + 1, 4, 4): [I, P0, P1 P0, P2 P1 P0, ...] (`registration.py:110`),
    composed in order in float32 (JAX's associative scan groups the
    products otherwise: float32 rounding apart, the same)."""
    out = [torch.eye(4, dtype=pairwise.dtype, device=pairwise.device)]
    for i, p in enumerate(pairwise):
        out.append(p if i == 0 else p @ out[-1])
    return torch.stack(out)


def _warp_f32(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """`ops.warp_by_flow` of a host (H, W) array in float32 (as JAX's pair
    loop warps), in numpy with the same operations; returns (H*W,)
    float64. Numpy, not torch: torch's CPU thread pool costs ~10 ms per
    small op on a loaded host, 0.3 s per pair."""
    h, w = img.shape
    img = np.asarray(img, np.float32)
    flow = np.asarray(flow, np.float32)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x = np.clip(gx + flow[..., 0], np.float32(0.0), np.float32(w - 1.000001))
    y = np.clip(gy + flow[..., 1], np.float32(0.0), np.float32(h - 1.000001))
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    xi, yi = x0.astype(np.int64), y0.astype(np.int64)
    x1, y1 = np.minimum(xi + 1, w - 1), np.minimum(yi + 1, h - 1)
    out = (img[yi, xi] * (1 - wx) * (1 - wy) + img[yi, x1] * wx * (1 - wy)
           + img[y1, xi] * (1 - wx) * wy + img[y1, x1] * wx * wy)
    return out.reshape(-1).astype(np.float64)


def two_frame_registration_np(depth0, depth1, flow, kinv0, kinv1, mask,
                              irls_iters: int = 5, grad_weighting: bool = True):
    """Host float64 rigid cam0 -> cam1 (4, 4) float32 for the Stage-1 pair
    loop (`registration.py:123`): Kabsch with IRLS Tukey reweighting (the
    cutoff from the residuals' MAD), the lift down-weighted where depth
    varies fast (silhouettes, creases). The flow warps of depth run in
    float32, as in JAX."""
    depth0 = np.asarray(depth0, np.float64)
    depth1 = np.asarray(depth1, np.float64)
    flow = np.asarray(flow, np.float64)
    mask = np.asarray(mask, np.float64)
    h, w = depth0.shape
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64),
                         indexing="xy")
    hp0 = np.stack([gx, gy, np.ones_like(gx)], -1).reshape(-1, 3)
    hp1 = np.stack([gx + flow[..., 0], gy + flow[..., 1], np.ones_like(gx)], -1).reshape(-1, 3)
    d1w = _warp_f32(depth1, flow)
    pts0 = (hp0 @ np.asarray(kinv0, np.float64).T) * depth0.reshape(-1, 1)
    pts1 = (hp1 @ np.asarray(kinv1, np.float64).T) * d1w[:, None]
    rel = 1.0
    if grad_weighting:
        g0y, g0x = np.gradient(depth0)
        g1y, g1x = np.gradient(depth1)
        grad = np.maximum(np.hypot(g0x, g0y).reshape(-1), _warp_f32(np.hypot(g1x, g1y), flow))
        sel = mask.reshape(-1) > 0
        gscale = max(np.median(grad[sel]) if sel.any() else 0.0, 1e-9)
        rel = 1.0 / (1.0 + (grad / (3.0 * gscale)) ** 2)
    base_w = mask.reshape(-1) * (d1w > 0) * rel

    def kabsch(weights):
        wn = weights / max(weights.sum(), 1e-8)
        m0 = (pts0 * wn[:, None]).sum(0)
        m1 = (pts1 * wn[:, None]).sum(0)
        u, _, vt = np.linalg.svd(((pts0 - m0) * wn[:, None]).T @ (pts1 - m1))
        r = vt.T @ np.diag([1.0, 1.0, np.linalg.det(vt.T @ u.T)]) @ u.T
        return r, m1 - r @ m0

    r, t = kabsch(base_w)
    on = base_w > 0
    for _ in range(irls_iters):
        resid = np.linalg.norm(pts0 @ r.T + t - pts1, axis=-1)
        med = np.median(resid[on]) if on.any() else 0.0
        mad = np.median(np.abs(resid[on] - med)) if on.any() else 0.0
        c = 4.685 * max(1.4826 * mad, 1e-9)  # Tukey cutoff from the MAD sigma
        weights = base_w * (1.0 - np.clip(resid / c, 0.0, 1.0) ** 2) ** 2
        if weights.sum() < 16:  # degenerate: keep the plain fit
            break
        r, t = kabsch(weights)
    rt = np.eye(4)
    rt[:3, :3] = r
    rt[:3, 3] = t
    return rt.astype(np.float32)
