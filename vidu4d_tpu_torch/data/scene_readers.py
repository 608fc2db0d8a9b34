"""Static-scene dataset readers: COLMAP and Blender (NeRF-synthetic)
(`vidu4d_tpu/data/scene_readers.py`; the port's own copy, numpy + struct).

Replaces `gs/scene/colmap_loader.py` + `gs/scene/dataset_readers.py` for the
static 2DGS pipeline: parses COLMAP binary reconstructions (cameras.bin /
images.bin / points3D.bin — the documented binary format) and Blender
transforms_*.json, producing camera lists (world-to-camera + intrinsics) and
an initialization point cloud.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class SceneCamera(NamedTuple):
    viewmat: np.ndarray  # (4, 4) world-to-camera
    intrins: np.ndarray  # (4,) fx, fy, cx, cy
    image_path: str
    width: int
    height: int


class SceneData(NamedTuple):
    train_cameras: List[SceneCamera]
    test_cameras: List[SceneCamera]
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    extent: float  # camera extent (densification scale reference)


def _qvec2rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read_colmap_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            n_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12}.get(model_id, 4)
            params = struct.unpack("<" + "d" * n_params, f.read(8 * n_params))
            if model_id == 0:  # SIMPLE_PINHOLE f, cx, cy
                k = (params[0], params[0], params[1], params[2])
            else:  # PINHOLE fx, fy, cx, cy (distortion params ignored)
                k = (params[0], params[1], params[2], params[3])
            cams[cam_id] = (np.asarray(k, np.float32), int(w), int(h))
    return cams


def _read_colmap_images_bin(path):
    images = []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            img_id = struct.unpack("<I", f.read(4))[0]
            qvec = struct.unpack("<dddd", f.read(32))
            tvec = struct.unpack("<ddd", f.read(24))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_pts = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_pts)  # skip 2D points
            images.append((name.decode(), qvec, tvec, cam_id))
    return images


def _read_colmap_points_bin(path):
    pts, cols = [], []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            struct.unpack("<Q", f.read(8))  # point id
            xyz = struct.unpack("<ddd", f.read(24))
            rgb = struct.unpack("<BBB", f.read(3))
            f.read(8)  # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
            pts.append(xyz)
            cols.append(rgb)
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32) / 255.0)


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False, llffhold: int = 8) -> SceneData:
    """COLMAP reconstruction -> SceneData (`dataset_readers.py` readColmapSceneInfo)."""
    sparse = os.path.join(path, "sparse", "0")
    cams = _read_colmap_cameras_bin(os.path.join(sparse, "cameras.bin"))
    images = _read_colmap_images_bin(os.path.join(sparse, "images.bin"))
    points, colors = _read_colmap_points_bin(os.path.join(sparse, "points3D.bin"))

    cameras = []
    for name, qvec, tvec, cam_id in sorted(images):
        k, w, h = cams[cam_id]
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3] = _qvec2rot(qvec)
        vm[:3, 3] = tvec
        cameras.append(SceneCamera(
            viewmat=vm, intrins=k,
            image_path=os.path.join(path, images_dir, name), width=w, height=h,
        ))
    centers = np.stack([np.linalg.inv(c.viewmat)[:3, 3] for c in cameras])
    extent = float(np.linalg.norm(centers - centers.mean(0), axis=1).max()) * 1.1

    if eval_split:
        train = [c for i, c in enumerate(cameras) if i % llffhold != 0]
        test = [c for i, c in enumerate(cameras) if i % llffhold == 0]
    else:
        train, test = cameras, []
    return SceneData(train, test, points, colors, extent)


def read_blender_scene(path: str, white_background: bool = False,
                       n_init_points: int = 100_000) -> SceneData:
    """NeRF-synthetic transforms_{train,test}.json -> SceneData
    (`dataset_readers.py` readNerfSyntheticInfo)."""
    def load_split(split):
        jpath = os.path.join(path, f"transforms_{split}.json")
        if not os.path.exists(jpath):
            return []
        with open(jpath) as f:
            meta = json.load(f)
        fov = meta["camera_angle_x"]
        cams = []
        for frame in meta["frames"]:
            c2w = np.asarray(frame["transform_matrix"], np.float32)
            c2w[:3, 1:3] *= -1  # blender GL -> CV
            vm = np.linalg.inv(c2w).astype(np.float32)
            img = frame["file_path"]
            img_path = os.path.join(path, img + ".png")
            # resolution read lazily; assume 800 (NeRF-synthetic default)
            w = h = 800
            fx = 0.5 * w / np.tan(0.5 * fov)
            cams.append(SceneCamera(
                viewmat=vm,
                intrins=np.asarray([fx, fx, w / 2, h / 2], np.float32),
                image_path=img_path, width=w, height=h,
            ))
        return cams

    train = load_split("train")
    test = load_split("test")
    rng = np.random.default_rng(0)
    points = (rng.uniform(size=(n_init_points, 3)) * 2.6 - 1.3).astype(np.float32)
    colors = rng.uniform(size=(n_init_points, 3)).astype(np.float32)
    return SceneData(train, test, points, colors, extent=4.0)


def read_scene(path: str, **kw) -> SceneData:
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, **kw)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, **kw)
    raise ValueError(f"unrecognized scene layout at {path}")
