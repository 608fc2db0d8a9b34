"""Camera trajectories for novel-view rendering and the render batch
(`vidu4d_tpu/utils/camera_trajectories.py`): numpy trajectory helpers, and
`construct_batch`, which returns torch tensors on a given device."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vidu4d_tpu_torch.ops.geometry import K2inv, hxy_grid
from vidu4d_tpu_torch.ops.quaternion import se3_to_quaternion_translation


def _rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(axis_angle)
    if theta < 1e-12:
        return np.eye(3)
    k = axis_angle / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def get_object_to_camera_matrix(theta_deg: float, axis, distance: float) -> np.ndarray:
    """(4, 4) object-to-camera rotating the object by ``theta_deg`` around
    ``axis``, ``distance`` in front of the camera."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    rt = np.eye(4)
    rt[:3, :3] = _rodrigues(axis * theta_deg / 180.0 * np.pi)
    rt[:3, 3] = [0, 0, distance]
    return rt


def get_rotating_cam(num_cameras, axis=(0, 1, 0), distance=3.0,
                     initial_angle=0.0, max_angle=360.0) -> np.ndarray:
    angles = np.linspace(initial_angle, max_angle, num_cameras)
    return np.stack([get_object_to_camera_matrix(a, axis, distance) for a in angles])


def get_fixed_cam(num_cameras, axis=(0, 1, 0), distance=3.0, angle=0.0) -> np.ndarray:
    rshift, lshift = np.eye(4)[None], np.eye(4)[None]
    lshift[0, :3, 3] = [0, 0, distance]
    rshift[0, :3, 3] = [0, 0, -distance]
    ext = get_rotating_cam(num_cameras, axis, 0.0, angle, angle)
    return lshift @ ext @ rshift


def get_bev_cam(field2cam: np.ndarray, elev: float = 90.0) -> np.ndarray:
    ave_depth = field2cam[:, 2, 3].mean()
    center2cam = get_object_to_camera_matrix(0, [1, 0, 0], ave_depth)[None]
    center2bev = get_object_to_camera_matrix(elev, [1, 0, 0], 2 * ave_depth)[None]
    return center2bev @ np.linalg.inv(center2cam) @ field2cam


def get_orbit_camera(num_cameras, max_angle=5.0, cycles=2) -> np.ndarray:
    max_angle = max_angle / 180 * np.pi
    out = np.tile(np.eye(4), (num_cameras, 1, 1))
    for i in range(num_cameras):
        aa = np.array([
            max_angle * np.cos(cycles * 2 * np.pi * i / num_cameras),
            max_angle * np.sin(cycles * 2 * np.pi * i / num_cameras),
            0.0,
        ])
        out[i, :3, :3] = _rodrigues(aa)
    return out


def construct_batch(
    inst_id: int,
    frameid_sub: np.ndarray,
    eval_res: int,
    field2cam: Optional[np.ndarray],
    camera_int: Optional[np.ndarray],
    crop2raw: Optional[np.ndarray],
    device,
) -> Dict[str, torch.Tensor]:
    """Render batch on ``device`` (`camera_trajectories.py:73`): the pixel
    grid of every frame, and optional overrides of the camera
    (``field2cam`` (N, 4, 4) -> (N, 7) quaternion + translation) and of the
    intrinsics (``camera_int`` (N, 4) -> Kinv)."""
    n = len(frameid_sub)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    batch = {
        "frameid_sub": torch.as_tensor(np.asarray(frameid_sub, np.int32), device=device),
        "dataid": torch.full((n,), inst_id, dtype=torch.int32, device=device),
        "hxy": hxy_grid(eval_res, eval_res, device=device)[None].expand(
            n, eval_res * eval_res, 3),
        "crop2raw": (f32(crop2raw) if crop2raw is not None
                     else f32([[1.0, 1.0, 0.0, 0.0]]).repeat(n, 1)),
    }
    if field2cam is not None:
        q, t = se3_to_quaternion_translation(f32(field2cam))
        batch["field2cam"] = torch.cat([q, t], dim=-1)
    if camera_int is not None:
        batch["Kinv"] = K2inv(f32(camera_int))
    return batch
