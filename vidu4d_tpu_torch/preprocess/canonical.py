"""Canonical (object-frame) camera registration
(`vidu4d_tpu/preprocess/canonical.py`): a CameraMLP fit by Adam to a unary
term (the annotated canonical rotations) and a pairwise term (relative
rotations of the chained Procrustes cameras), in two phases, each from a
fresh Adam state: pairwise only, then both.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.engine.optim import adam_step_
from vidu4d_tpu_torch.models.fields.time_mlp import CameraMLP, init_camera_base_params
from vidu4d_tpu_torch.ops.geometry import rot_angle
from vidu4d_tpu_torch.ops.quaternion import quaternion_translation_to_se3


def camera_model(num_frames: int, seed: int = 0) -> CameraMLP:
    """The fit's CameraMLP (width 128, depth 3) on the CPU, initialised
    from ``seed`` (so every device starts from the same weights)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return CameraMLP(FrameInfo.single_video(num_frames), depth=3, width=128)


def canonical_loss(model: CameraMLP, rel_gt: torch.Tensor, anno: torch.Tensor,
                   anno_idx: torch.Tensor, unary_wt: float) -> torch.Tensor:
    """unary_wt x the mean angle between the predicted and the annotated
    rotations of frames anno_idx + the mean angle between the predicted
    relative rotations of consecutive frames and rel_gt (T-1, 3, 3)
    (`canonical.py:54`). Every angle is `rot_angle`'s, clipped to
    >= 0.0141 rad (its gradient is 0 below that)."""
    quat, trans = model(torch.arange(anno.shape[0], device=anno.device))
    pred = quaternion_translation_to_se3(quat, trans)
    unary = rot_angle(pred[anno_idx, :3, :3] @ anno[anno_idx, :3, :3].transpose(-1, -2)).mean()
    rel = pred[1:, :3, :3] @ pred[:-1, :3, :3].transpose(-1, -2)
    return unary_wt * unary + rot_angle(rel @ rel_gt.transpose(-1, -2)).mean()


def canonical_registration(
    cams_canonical: Dict[int, np.ndarray],  # frame -> (4, 4) annotated cams
    cams_view1: np.ndarray,  # (T, 4, 4) chained Procrustes cameras
    num_iter: int = 2000,
    lr: float = 5e-4,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """(T, 4, 4) canonical object-to-camera transforms (the
    ``01-canonical.npy`` contract) and the final loss
    (`canonical.py:31`), fitting `camera_model(T)` whose base quaternion is
    set from the annotations."""
    t = len(cams_view1)
    anno_idx = torch.as_tensor(sorted(cams_canonical), dtype=torch.long, device=device)
    cams_anno = np.tile(np.eye(4, dtype=np.float32), (t, 1, 1))
    for k, v in cams_canonical.items():
        cams_anno[k] = v
    view1 = np.asarray(cams_view1, np.float32)
    rel_gt = torch.as_tensor(view1[1:, :3, :3] @ np.transpose(view1[:-1, :3, :3], (0, 2, 1)),
                             device=device)
    anno = torch.as_tensor(cams_anno, device=device)

    frame_info = FrameInfo.single_video(t)
    model = camera_model(t).to(device)
    init_camera_base_params(model, cams_anno, frame_info)
    params = [p for p in model.parameters() if p.requires_grad]
    for unary_wt in (0.0, 1.0):  # pairwise only, then unary + pairwise
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        for step in range(1, num_iter + 1):
            loss = canonical_loss(model, rel_gt, anno, anno_idx, unary_wt)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            adam_step_(params, grads, mu, nu, step, lr)
    with torch.no_grad():
        final = float(canonical_loss(model, rel_gt, anno, anno_idx, 1.0))
        quat, trans = model(torch.arange(t, device=device))
        cams = quaternion_translation_to_se3(quat, trans).cpu().numpy()
    return cams, final


def translation_from_bbox(depth_med: float, bbox_wh: np.ndarray, focal: float,
                          obj_size: float = 0.5) -> np.ndarray:
    """Bbox-depth translation heuristic (`canonical.py:90`): z ~ focal *
    obj_size / bbox extent."""
    extent = max(float(np.max(bbox_wh)), 1.0)
    return np.array([0.0, 0.0, focal * obj_size / extent], np.float32)
