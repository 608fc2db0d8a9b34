"""Export the canonical geometry and the per-frame motion (`vidu4d_tpu/export.py`).

    python -m vidu4d_tpu_torch.export --flagfile=logdir/<seq>-<log>/opts.log \\
        --load_suffix latest --inst_id 0 [--export_mesh_stride 4] [--device cpu]

Writes ``export_NNNN/`` in the run directory: the canonical geometry,
``motion.json`` (per frame: field2cam quaternion and translation in world
units, the bones' dual quaternions ``t_articulation`` qr / qd when the
warp has bones, and the joints' axis-angles ``joint_so3`` when they form a
skeleton; `reanimate` reads the first two) and, with ``--export_mesh_seq``
(default), ``fg-NNNNN.obj``: the canonical geometry warped to every
``export_mesh_stride``-th frame. Stage 3 (a "gs" ``fg_motion``): the alive
surfels as ``canonical-surfels.ply`` (3DGS layout), their centres as the
OBJ point sets. Stage 2: the proxy mesh of the SDF on a ``--grid_size``
grid as ``canonical-mesh.obj``, warped with its faces.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch import config
from vidu4d_tpu_torch.models.fields.skeleton import ArticulationSkelMLP
from vidu4d_tpu_torch.models.gaussian.ply_io import save_ply
from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams
from vidu4d_tpu_torch.ops.marching import save_obj
from vidu4d_tpu_torch.ops.quaternion import quaternion_translation_apply
from vidu4d_tpu_torch.render import build_trainer, camera_modules


@torch.no_grad()
def export_motion_params(trainer, frameid: np.ndarray, path: str) -> Dict:
    """``motion.json`` at raw frame ids (`export.py:29`): field2cam as
    (quat, trans / exp(logscale)) of the Stage-3 deformer or of the Stage-2
    model's first field (fg, for "comp"), the articulation as (qr, qd), a
    skeleton's joint angles (B, 3) per frame as ``joint_so3``."""
    owner, _ = camera_modules(trainer)
    fid = torch.as_tensor(np.asarray(frameid), device=trainer.device)
    q, t = owner.camera_mlp(fid)
    npy = lambda x: x.cpu().numpy().tolist()
    motion = {"field2cam": {"quat": npy(q), "trans": npy(t / torch.exp(owner.logscale))}}
    if hasattr(owner.warp, "articulation"):
        art = owner.warp.articulation
        qr, qd = art(fid)
        motion["t_articulation"] = {"qr": npy(qr), "qd": npy(qd)}
        if isinstance(art, ArticulationSkelMLP):
            motion["joint_so3"] = npy(art.so3_at(fid))
    with open(path, "w") as f:
        json.dump(motion, f)
    return motion


@torch.no_grad()
def export_mesh_sequence(trainer, frameid: np.ndarray, save_dir: str, stride: int = 1) -> None:
    """The canonical geometry warped to every ``stride``-th frame, in field
    space, as ``fg-%05d.obj`` (`export.py:80`): the alive surfel centres as
    point sets (Stage 3), or the proxy mesh with its faces (Stage 2)."""
    owner, _ = camera_modules(trainer)
    if hasattr(trainer, "surfels"):
        xyz = trainer.surfels.params.xyz.detach()
        keep, faces = trainer.surfels.alive, np.zeros((0, 3), np.int32)
    else:
        if trainer._proxy_mesh is None:
            raise RuntimeError("the SDF has no zero level set inside the grid: "
                               "no proxy mesh to export")
        verts, faces = trainer._proxy_mesh
        xyz = torch.as_tensor(verts, device=trainer.device)
        keep = torch.ones(len(verts), dtype=torch.bool, device=trainer.device)
    inst = torch.zeros((1,), dtype=torch.int32, device=trainer.device)
    for f in np.asarray(frameid)[::stride]:
        fid = torch.as_tensor([int(f)], device=trainer.device)
        (q, t), _ = owner.warp(xyz[None, :, None], fid, inst, return_qt=True)
        warped = quaternion_translation_apply(q[0, :, 0], t[0, :, 0], xyz)[keep]
        save_obj(os.path.join(save_dir, "fg-%05d.obj" % int(f)), warped.cpu().numpy(), faces)


def export(opts: Dict, device="cuda") -> str:
    """Write ``export_<inst_id>/`` (`export.py:125`). Returns its path."""
    trainer = build_trainer(opts, device)
    offsets = np.asarray(trainer.frame_info.frame_offset_raw)
    vid = opts["inst_id"]
    frameid = np.arange(offsets[vid], offsets[vid + 1])
    save_dir = os.path.join(trainer.save_dir, "export_%04d" % vid)
    os.makedirs(save_dir, exist_ok=True)
    if hasattr(trainer, "surfels"):
        s = trainer.surfels
        save_ply(os.path.join(save_dir, "canonical-surfels.ply"),
                 SurfelParams(*[p.detach().cpu().numpy() for p in s.params]),
                 s.alive.cpu().numpy())
    else:
        trainer.update_geometry_aux(beta=0.0, grid_size=opts.get("grid_size", 128))
        trainer.export_proxy_mesh(os.path.join(save_dir, "canonical-mesh.obj"))
    export_motion_params(trainer, frameid, os.path.join(save_dir, "motion.json"))
    if opts.get("export_mesh_seq", True):
        export_mesh_sequence(trainer, frameid, save_dir,
                             stride=opts.get("export_mesh_stride", 1))
    print(f"exported to {save_dir}")
    return save_dir


def main(argv: Optional[Sequence[str]] = None) -> str:
    opts = config.parse_flags(sys.argv[1:] if argv is None else argv, config.EXPORT_FLAGS)
    device = opts.pop("device")
    return export(opts, device)


if __name__ == "__main__":
    main()
