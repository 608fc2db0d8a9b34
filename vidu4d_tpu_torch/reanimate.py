"""Re-drive a trained model with exported motion (`vidu4d_tpu/reanimate.py`).

    python -m vidu4d_tpu_torch.export --flagfile=<motion run>/opts.log --load_suffix latest
    python -m vidu4d_tpu_torch.reanimate --flagfile=<model run>/opts.log \\
        --load_suffix latest --motion_path <motion run>/export_0000/motion.json

Renders the model's first frame under each exported frame's camera and
articulation, with the viewpoint's intrinsics, into ``reanimation/`` of
the run directory. Takes the render CLI's flags too. Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch import config
from vidu4d_tpu_torch.render import build_trainer, construct_batch_from_opts
from vidu4d_tpu_torch.utils.io import save_rendered


def reanimate(opts: Dict, device="cuda") -> Dict[str, np.ndarray]:
    """Render ``opts["motion_path"]``'s frames (`reanimate.py:23`): the
    batch of frame 0 repeated, its field2cam and t_articulation replaced
    by the motion's (its ``joint_so3`` is not read, as in the JAX
    package). Returns the (N, res, res, c) numpy outputs."""
    trainer = build_trainer(opts, device)
    with open(opts["motion_path"]) as f:
        motion = json.load(f)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=trainer.device)
    quat, trans = f32(motion["field2cam"]["quat"]), f32(motion["field2cam"]["trans"])
    batch = construct_batch_from_opts({**opts, "freeze_id": 0, "num_frames": len(quat)},
                                      trainer)
    batch["field2cam"] = torch.cat([quat, trans], dim=-1)
    if "t_articulation" in motion:
        art = motion["t_articulation"]
        batch["t_articulation"] = torch.stack([f32(art["qr"]), f32(art["qd"])], dim=-2)
    rendered = trainer.render_batch(batch, res=opts["render_res"])
    save_dir = os.path.join(trainer.save_dir, "reanimation")
    save_rendered(rendered, save_dir)
    print(f"saved reanimation to {save_dir}")
    return rendered


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    opts = config.parse_flags(sys.argv[1:] if argv is None else argv,
                              config.REANIMATE_FLAGS)
    device = opts.pop("device")
    return reanimate(opts, device)


if __name__ == "__main__":
    main()
