"""The Stage-3 scene builder: a cloud placed through the warp onto the
database's object. Frozen from ``chip_smoke.py`` at commit 1fb37daff6a2
(`scene_target`, `calibrate_scene`, and the identity camera of
`build_trainer`), driven through the plain reference's warp
(`portbench.reference`), never the program's."""

from __future__ import annotations

import numpy as np
import torch

from portbench import database


def scene_target(n: int) -> np.ndarray:
    """Camera-space points the cloud is placed at: an ellipsoid shell of
    semi-axes 2 sd with 1% radial jitter about (0, 0, 0.38), 1% of the
    points moved to a sparse halo in the box of 3 sd (surfels on a surface,
    as in a trained scene, which the radius-outlier rule keeps, and stray
    ones, which it prunes). Drawn from a fixed generator: every seed places
    the same geometry."""
    rngl = np.random.default_rng(1)
    sd = np.array(database.AXES) / 2.0
    centre = np.array([0.0, 0.0, database.OBJECT_DEPTH])
    u = rngl.normal(size=(n, 3))
    pts = (u / np.linalg.norm(u, axis=-1, keepdims=True) * 2.0 * sd
           * (1.0 + 0.01 * rngl.normal(size=(n, 1))))
    halo = rngl.permutation(n)[:n // 100]
    pts[halo] = rngl.uniform(-3.0 * sd, 3.0 * sd, (len(halo), 3))
    return (pts + centre).astype(np.float32)


@torch.no_grad()
def identity_camera(P) -> None:
    """The camera MLP's output layers (in the deformer's parameters ``P``)
    set to the identity pose in every frame, so that every frame sees the
    object, as a video's camera keeps its subject in view."""
    for head, bias in (("trans_head", (0.0, 0.0, 0.0)), ("quat_head", (1.0, 0.0, 0.0, 0.0))):
        P[f"camera_mlp.{head}.out.weight"].zero_()
        P[f"camera_mlp.{head}.out.bias"].copy_(torch.tensor(bias))


def calibrate(to_cam, pts: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Affine-fit cam = world @ A + b through the warp (``to_cam``: points
    (N, 3) -> camera points of each frame (M, N, 3)) on a subsample, solve
    for a cloud that lands on the camera-space ``target`` points; iterate
    to absorb the warp's nonlinearity."""
    n = pts.shape[0]
    sub = np.arange(0, n, max(1, n // 2048))
    for _ in range(3):
        xc = to_cam(pts)
        x_s = np.concatenate([pts[sub]] * xc.shape[0])
        y_s = np.concatenate([xc[f][sub] for f in range(xc.shape[0])])
        xh = np.concatenate([x_s, np.ones((len(x_s), 1), np.float32)], 1)
        w, *_ = np.linalg.lstsq(xh, y_s, rcond=None)
        pts = ((target - w[3]) @ np.linalg.pinv(w[:3], rcond=1e-3)).astype(np.float32)
    return pts
