"""Visualization utilities (`vidu4d_tpu/utils/vis.py`; replaces
`lab4d/utils/vis_utils.py`), numpy only.

img2color (PCA feature colorization, depth/score colormaps), camera-frustum
meshes (draw_cams), image grids for tensorboard.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def img2color(tag: str, img: np.ndarray, pca_fn: Optional[Callable] = None):
    """Map a rendered quantity to RGB in [0, 1] (`vis_utils.py` img2color)."""
    img = np.asarray(img, np.float32)
    if "rgb" in tag or "rendered" in tag:
        return np.clip(img[..., :3], 0, 1)
    if "feature" in tag and pca_fn is not None:
        feat = pca_fn(img)
        lo, hi = feat.min(), feat.max()
        return (feat - lo) / max(hi - lo, 1e-6)
    if "depth" in tag:
        d = img[..., 0] if img.ndim == 3 else img
        d = d / max(d.max(), 1e-6)
        return np.stack([d] * 3, -1)
    if "mask" in tag or "vis" in tag:
        m = img[..., 0] if img.ndim == 3 else img
        return np.stack([np.clip(m, 0, 1)] * 3, -1)
    if "normal" in tag:
        return np.clip(img[..., :3] * 0.5 + 0.5, 0, 1)
    if "flow" in tag:
        mag = np.linalg.norm(img[..., :2], axis=-1)
        ang = np.arctan2(img[..., 1], img[..., 0])
        h = (ang + np.pi) / (2 * np.pi)
        v = np.clip(mag / max(mag.max(), 1e-6), 0, 1)
        return _hsv_to_rgb(h, np.ones_like(h), v)
    # fallback: normalize first channel
    x = img[..., 0] if img.ndim == 3 else img
    x = (x - x.min()) / max(x.max() - x.min(), 1e-6)
    return np.stack([x] * 3, -1)


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    out = np.zeros(h.shape + (3,), np.float32)
    for k, (r, g, b) in enumerate(
        [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    ):
        m = i == k
        out[m] = np.stack([r[m], g[m], b[m]], -1)
    return out


def make_image_grid(images: List[np.ndarray], cols: int = 4) -> np.ndarray:
    """Tile images (H, W, 3) into a grid (`vis_utils.py` make_image_grid)."""
    if not images:
        return np.zeros((1, 1, 3), np.float32)
    h, w = images[0].shape[:2]
    rows = -(-len(images) // cols)
    grid = np.zeros((rows * h, cols * w, 3), np.float32)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img[..., :3]
    return grid


def camera_frustum_mesh(rtmat: np.ndarray, scale: float = 0.05):
    """Wireframe-ish frustum mesh for one object-to-camera SE(3)."""
    c2o = np.linalg.inv(rtmat)
    pts_cam = np.array(
        [[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32
    ) * scale
    pts = pts_cam @ c2o[:3, :3].T + c2o[:3, 3]
    faces = np.array(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4]],
        np.int32,
    )
    return pts, faces


def draw_cams(rtmats: np.ndarray, scale: float = 0.05):
    """Concatenated frustum mesh over a camera trajectory
    (`vis_utils.py` draw_cams). Returns (verts, faces) numpy arrays."""
    rtmats = np.asarray(rtmats)
    # subsample to at most 200 cams like the reference
    step = max(1, len(rtmats) // 200)
    verts_all, faces_all = [], []
    offset = 0
    for rt in rtmats[::step]:
        v, f = camera_frustum_mesh(rt, scale=scale)
        verts_all.append(v)
        faces_all.append(f + offset)
        offset += len(v)
    return np.concatenate(verts_all), np.concatenate(faces_all)
