"""The benchmark's Stage-1 database: a seeded object seen by a fixed camera.

Written in the Stage-1 npy layout that both trainers read (the layout of
``tests/helpers.make_fake_db`` at commit 1fb37daff6a2, whose content was
uniform noise). Here every map is that of one object: the ellipsoid shell
that the Stage-3 cloud is calibrated onto (`scene.scene_target`), semi-axes
2 sd = (0.10, 0.12, 0.07), centred on the optical axis at depth
``OBJECT_DEPTH``, turning about its vertical axis by ``TURN_DEG`` a frame,
seen through pixel-true intrinsics (focal ``FOCAL_X`` x resolution). Per
frame: the colour (a smooth seeded texture of the surface point over a
grey background), the mask, the depth, the flow towards every frame pair
the loader draws (deltas 1, 2, 4, 8; the third channel is 1 where the point
is visible in both frames) and 16-dim features on the 112 x 112 grid of
Stage 1's DINOv2 maps (a seeded smooth map of the surface point,
L2-normalised, zero off the object). The cameras are the identity rotation
at ``CAMERA_Z``: Stage 2 scales their translations by 0.1, which puts the
object at ``OBJECT_DEPTH`` there too.

Everything is drawn from ``seed`` on ``device`` in a few large calls; the
same seed writes the same bytes.
"""

from __future__ import annotations

import configparser
import math
import os

import numpy as np
import torch

AXES = (0.10, 0.12, 0.07)
OBJECT_DEPTH = 0.38
CAMERA_Z = 3.8
FOCAL_X = 1.2
TURN_DEG = 6.0
BACKGROUND = 0.5
DELTAS = (1, 2, 4, 8)
FEATURE_GRID, FEATURE_DIM = 112, 16
SEQ = "bench"


def _rot_y(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _hit(res: int, rots: torch.Tensor, grid: int = None):
    """Ray-cast the turned ellipsoid through every pixel (x, y) of a
    ``grid`` x ``grid`` raster of the res x res image, for each frame's
    rotation. Returns (canonical hit point (T, g, g, 3), depth (T, g, g),
    hit mask (T, g, g))."""
    g = grid or res
    dev = rots.device
    pix = torch.arange(g, device=dev, dtype=torch.float64) * (res / g)
    y, x = torch.meshgrid(pix, pix, indexing="ij")
    f, c = FOCAL_X * res, res / 2.0
    d = torch.stack([(x - c) / f, (y - c) / f, torch.ones_like(x)], -1)  # (g, g, 3)
    centre = torch.tensor([0.0, 0.0, OBJECT_DEPTH], device=dev, dtype=torch.float64)
    inv_a2 = 1.0 / torch.tensor(AXES, device=dev, dtype=torch.float64) ** 2
    # object frame: p = R^T (s d - C), so (s e - q)^T A (s e - q) = 1
    e = torch.einsum("tji,hwj->thwi", rots, d)
    q = torch.einsum("tji,j->ti", rots, centre)[:, None, None, :]
    qa = (e * e * inv_a2).sum(-1)
    qb = -2.0 * (e * q * inv_a2).sum(-1)
    qc = (q * q * inv_a2).sum(-1) - 1.0
    disc = qb * qb - 4.0 * qa * qc
    hit = disc > 0
    s = (-qb - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * qa)
    p = s[..., None] * e - q
    return p, s, hit


def _texture(p: torch.Tensor, freqs: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """A smooth map of canonical points (..., 3) -> (..., k): sines of
    seeded directions."""
    return torch.sin(p @ freqs + phase)


def write_database(root: str, seed: int, res: int, frames: int, device) -> str:
    """Write ``<root>/database`` for ``frames`` frames at ``res`` x ``res``;
    returns its path."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f64 = torch.float64
    # texture and feature maps of the surface, drawn from the seed
    col_freq = torch.randn((3, 3), generator=gen, device=dev, dtype=f64) * 40.0
    col_phase = torch.rand((3,), generator=gen, device=dev, dtype=f64) * 2 * math.pi
    feat_freq = torch.randn((3, FEATURE_DIM), generator=gen, device=dev, dtype=f64) * 25.0
    feat_phase = torch.rand((FEATURE_DIM,), generator=gen, device=dev, dtype=f64) * 2 * math.pi

    turn = math.radians(TURN_DEG)
    rots = _rot_y(torch.arange(frames, device=dev, dtype=f64) * turn)
    p, depth, hit = _hit(res, rots)
    hitf = hit.to(f64)[..., None]
    rgb = BACKGROUND + hitf * 0.4 * _texture(p, col_freq, col_phase)
    depth_map = torch.where(hit, depth, torch.full_like(depth, OBJECT_DEPTH + 2 * max(AXES)))
    mask = torch.stack([hit.to(f64), torch.ones_like(depth)], -1)

    fp, _, fhit = _hit(res, rots, FEATURE_GRID)
    feat = _texture(fp, feat_freq, feat_phase)
    feat = feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True), min=1e-12)
    feat = feat * fhit.to(f64)[..., None]

    # flow of each visible point towards frame t + delta (and back)
    f, c = FOCAL_X * res, res / 2.0
    centre = torch.tensor([0.0, 0.0, OBJECT_DEPTH], device=dev, dtype=f64)
    inv_a2 = 1.0 / torch.tensor(AXES, device=dev, dtype=f64) ** 2
    pix = torch.arange(res, device=dev, dtype=f64)
    yy, xx = torch.meshgrid(pix, pix, indexing="ij")

    def flow(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        pc = p[src]  # (n, H, W, 3) canonical points seen in the source frames
        x = torch.einsum("nij,nhwj->nhwi", rots[dst], pc) + centre
        normal = torch.einsum("nij,nhwj->nhwi", rots[dst], pc * inv_a2)
        visible = (normal * x).sum(-1) < 0
        u = f * x[..., 0] / x[..., 2] + c - xx
        v = f * x[..., 1] / x[..., 2] + c - yy
        ok = hit[src] & visible
        return torch.stack([u * ok, v * ok, ok.to(f64)], -1)

    base = os.path.join(str(root), "database")
    prefix = f"crop-{res}"
    proc = os.path.join(base, "processed")

    def save(sub: str, name: str, arr: torch.Tensor, dtype=np.float16) -> None:
        d = os.path.join(proc, sub, "Full-Resolution", f"{SEQ}-0000")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, name), arr.cpu().numpy().astype(dtype))

    save("JPEGImages", f"{prefix}.npy", rgb)
    save("Depth", f"{prefix}.npy", depth_map)
    save("Annotations", f"{prefix}.npy", mask)
    save("Annotations", f"{prefix}-crop2raw.npy",
         torch.tensor([[1.0, 1.0, 0.0, 0.0]], dtype=f64).repeat(frames, 1), np.float32)
    save("Annotations", f"{prefix}-is_detected.npy", torch.ones(frames, dtype=f64), np.float64)
    save("Features", f"{prefix}-dinov2-01.npy", feat)
    for d in DELTAS:
        n = frames // d
        if n < 2:
            continue
        k = torch.arange(n - (1 if n * d >= frames else 0), device=dev)
        # forward entry k: frame k*d -> k*d + d; backward entry k: (k+1)*d -> k*d
        save(f"FlowFW_{d}", f"{prefix}.npy", flow(k * d, k * d + d))
        save(f"FlowBW_{d}", f"{prefix}.npy", flow(k * d + d, k * d))
    cams = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
    cams[:, 2, 3] = CAMERA_Z
    cam_dir = os.path.join(proc, "Cameras", "Full-Resolution", f"{SEQ}-0000")
    os.makedirs(cam_dir, exist_ok=True)
    np.save(os.path.join(cam_dir, "00.npy"), cams)
    np.save(os.path.join(cam_dir, "01-canonical.npy"), cams)

    cfg = configparser.ConfigParser()
    cfg["data"] = {"init_frame": "0", "end_frame": "-1"}
    fx = FOCAL_X * res
    cfg["data_0"] = {
        "ks": f"{fx} {fx} {res / 2} {res / 2}",
        "shape": f"{res} {res}",
        "img_path": os.path.join(proc, "JPEGImages", "Full-Resolution", f"{SEQ}-0000"),
    }
    os.makedirs(os.path.join(base, "configs"), exist_ok=True)
    with open(os.path.join(base, "configs", f"{SEQ}.config"), "w") as fh:
        cfg.write(fh)
    return base


def intrinsics_prior(res: int, frames: int) -> np.ndarray:
    """(frames, 4) fx, fy, cx, cy of the database's camera."""
    return np.tile(np.array([FOCAL_X * res, FOCAL_X * res, res / 2, res / 2], np.float32),
                   (frames, 1))
