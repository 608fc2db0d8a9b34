"""Reference-view and novel-view rendering CLI (`vidu4d_tpu/render.py`).

    python -m vidu4d_tpu_torch.render --flagfile=logdir/<seq>-<log>/opts.log \\
        --load_suffix latest --render_res 512 --viewpoint rot_0_360 [--device cpu]

Viewpoints: "ref" (the training cameras), "rot_e_d" (d degrees around the
object at elevation e), "bev_e" (bird's eye at elevation e), "refrot_*"
(the training camera trajectory swept over the clip), "novel_e_d" (one
training camera, zoomed out 1.2x, held). Renders go to
``<logroot>/<seq>-<log>/renderings_NNNN/<viewpoint>/``. A ``fg_motion``
with "gs" renders the Stage-3 surfels (the forward tile kernel), any other
the Stage-2 neural SDF (volume rendering in chunks of rays). Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch import config
from vidu4d_tpu_torch.ops.quaternion import quaternion_translation_to_se3
from vidu4d_tpu_torch.utils.camera_trajectories import (
    construct_batch,
    get_bev_cam,
    get_object_to_camera_matrix,
    get_rotating_cam,
)
from vidu4d_tpu_torch.utils.io import save_rendered


def build_trainer(opts: Dict, device="cuda"):
    """The trainer of ``opts`` (Stage 3 for a "gs" ``fg_motion``, else
    Stage 2) with its ``ckpt_<load_suffix>.pth`` (default "latest")
    loaded, step counters included (`render.py:31`)."""
    if "gs" in opts["fg_motion"]:
        from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer as Trainer
    else:
        from vidu4d_tpu_torch.engine.trainer import Stage2Trainer as Trainer
    trainer = Trainer(opts, device)
    suffix = opts.get("load_suffix") or "latest"
    trainer.load_checkpoint(os.path.join(trainer.save_dir, f"ckpt_{suffix}.pth"),
                            reset_steps=False)
    return trainer


def _frames(trainer, frameid) -> torch.Tensor:
    return torch.as_tensor(np.asarray(frameid), device=trainer.device)


def camera_modules(trainer):
    """(the module holding camera_mlp and logscale, the intrinsics MLP):
    the Stage-3 deformer, or the Stage-2 model's first field."""
    if hasattr(trainer, "deformer"):
        return trainer.deformer, trainer.deformer.intrinsics
    return trainer.model.fields[list(trainer.states)[0]], trainer.model.intrinsics


@torch.no_grad()
def get_field_cameras(trainer, frameid) -> np.ndarray:
    """(N, 4, 4) field-to-camera matrices in world units at raw frame ids:
    the camera MLP's translation over exp(logscale) (`render.py:47`)."""
    owner, _ = camera_modules(trainer)
    q, t = owner.camera_mlp(_frames(trainer, frameid))
    return quaternion_translation_to_se3(q, t / torch.exp(owner.logscale)).cpu().numpy()


@torch.no_grad()
def get_intrinsics(trainer, frameid) -> np.ndarray:
    """(N, 4) fx, fy, cx, cy at raw frame ids (`render.py:75`)."""
    return camera_modules(trainer)[1](_frames(trainer, frameid)).cpu().numpy()


def object_size(trainer) -> float:
    """Largest extent of the alive surfels, or of the Stage-2 field's aabb
    (`render.py:89`)."""
    if not hasattr(trainer, "surfels"):
        aabb = trainer.states[list(trainer.states)[0]].aabb.cpu().numpy()
        return float((aabb[1] - aabb[0]).max())
    alive = trainer.surfels.alive
    xyz = trainer.surfels.params.xyz.detach()[alive].cpu().numpy()
    return float((xyz.max(0) - xyz.min(0)).max()) if len(xyz) else 1.0


def _scaled_intrinsics(intrinsics_fr: np.ndarray, raw_size, res: int) -> np.ndarray:
    """The training intrinsics rescaled from the raw image to res x res."""
    sx, sy = raw_size[1] / res, raw_size[0] / res
    return np.stack([intrinsics_fr[:, 0] / sx, intrinsics_fr[:, 1] / sy,
                     intrinsics_fr[:, 2] / sx, intrinsics_fr[:, 3] / sy], axis=-1)


def construct_batch_from_opts(opts: Dict, trainer) -> Dict[str, torch.Tensor]:
    """The render batch of ``opts``' viewpoint on the trainer's device
    (`render.py:98-226`)."""
    video_id = opts["inst_id"]
    raw_size = trainer.data_info["raw_size"][video_id]
    offsets = np.asarray(trainer.frame_info.frame_offset_raw)
    vid_length = offsets[video_id + 1] - offsets[video_id]
    if opts["freeze_id"] == -1:
        frameid_sub = np.arange(vid_length - 1)
    else:
        n = opts["num_frames"] if opts["num_frames"] > 0 else vid_length
        frameid_sub = np.full((n,), opts["freeze_id"])
    frameid = frameid_sub + offsets[video_id]
    intrinsics_fr = get_intrinsics(trainer, frameid)
    res = opts["render_res"]
    centred = np.tile([res, res, res / 2, res / 2], (len(frameid_sub), 1))

    viewpoint = opts["viewpoint"]
    if viewpoint == "ref":
        field2cam, camera_int = None, _scaled_intrinsics(intrinsics_fr, raw_size, res)
    elif viewpoint.startswith("rot"):
        elev, max_angle = [int(v) for v in viewpoint.split("_")[1:]]
        cam_traj = get_rotating_cam(len(frameid_sub),
                                    distance=object_size(trainer) * opts["rot_dist"],
                                    max_angle=max_angle)
        field2cam = cam_traj @ get_object_to_camera_matrix(elev, [1, 0, 0], 0)[None]
        camera_int = centred
    elif viewpoint.startswith("bev"):
        elev = int(viewpoint.split("_")[1])
        field2cam = get_bev_cam(get_field_cameras(trainer, frameid), elev=elev)
        camera_int = centred
    elif viewpoint.startswith("refrot"):
        # the training camera trajectory swept across the clip while the
        # motion plays at its own time (its elev / max_angle are unused, as
        # in `lab4d/render.py:185-218`)
        index_sub = np.linspace(0, vid_length - 1, len(frameid_sub), dtype=int)
        field2cam = get_field_cameras(trainer, index_sub + offsets[video_id])
        camera_int = _scaled_intrinsics(intrinsics_fr, raw_size, res)
    elif viewpoint.startswith("novel"):
        # one training camera, picked by max_angle as a fraction of the
        # clip, zoomed out 1.2x and held for the whole motion
        _, max_angle = [int(v) for v in viewpoint.split("_")[1:]]
        pick = int(round((vid_length - 1) * (max_angle % 360) / 360.0))
        cam = get_field_cameras(trainer, np.array([pick + offsets[video_id]]))[0].copy()
        cam[:3, 3] *= 1.2
        field2cam = np.tile(cam[None], (len(frameid_sub), 1, 1))
        camera_int = _scaled_intrinsics(intrinsics_fr, raw_size, res)
    else:
        raise ValueError(f"unknown viewpoint {viewpoint!r}")
    return construct_batch(inst_id=video_id, frameid_sub=frameid_sub, eval_res=res,
                           field2cam=field2cam, camera_int=camera_int, crop2raw=None,
                           device=trainer.device)


def render(opts: Dict, device="cuda") -> Dict[str, np.ndarray]:
    """Render ``opts``' viewpoint from its checkpoint and save the outputs
    (`render.py:229`). Returns the (M, res, res, c) numpy outputs."""
    trainer = build_trainer(opts, device)
    batch = construct_batch_from_opts(opts, trainer)
    rendered = trainer.render_batch(batch, res=opts["render_res"],
                                    no_warp=opts.get("nowarp", False))
    save_dir = os.path.join(trainer.save_dir, "renderings_%04d" % opts["inst_id"],
                            opts["viewpoint"])
    save_rendered(rendered, save_dir)
    print(f"saved renderings to {save_dir}")
    return rendered


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """``--logdir``: a run directory whose ``opts.json`` (the trainer's
    option dict) is merged over the flags, for runs without an opts.log;
    the render flags (``--inst_id``, ``--viewpoint``, ...) stay the command
    line's (a trainer built by an earlier render writes them into
    ``opts.json`` too)."""
    opts = config.parse_flags(sys.argv[1:] if argv is None else argv, config.RENDER_FLAGS)
    device = opts.pop("device")
    if opts["logdir"]:
        with open(os.path.join(opts["logdir"], "opts.json")) as f:
            opts.update({k: v for k, v in json.load(f).items()
                         if k not in config.RENDER_FLAGS})
    return render(opts, device)


if __name__ == "__main__":
    main()
