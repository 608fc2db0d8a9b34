"""Profile the port's Stage-3 step (or the static 2DGS step, or the
Stage-2 step) on one CUDA GPU with torch.profiler.

    python3 scripts/profile_torch_step.py [--reduced | --static | --stage2 | --stage2-comp]

Builds the chip_smoke.py workload (200k surfels, 256x256, 2 frames;
calibrated cloud, one fixed batch) in the default configuration (with
--reduced: --nogs_optim_warp --rgb_loss_only --flow_wt 0), warms up, then
profiles a few steps. With --static: chip_smoke.py's static scene (1237 x
822, `tests/torch_parity.static_scene`), its 100k initial points in 400k
slots as `gs_static` starts them, `gs_trainer.train_step` at SH 0 on
camera 0. With --stage2: chip_smoke.py's Stage-2 workload (the README
recipe, S2_FLAGS: 256 pairs x 16 pixels x 64 samples, an 8 x 256 field,
make_fake_db(T=16) at 256^2), `Stage2Trainer.train_step` with its own
batch reads (the host part of a training step), from the seeded
parameters with the intrinsics and cameras at their priors. With
--stage2-comp: the same for chip_smoke.py's [stage2-comp-skel] workload
(S2C_FLAGS: --field_type comp --fg_motion skel-quad, two fields).
Prints the card, the wall time per step, the summed device time per step,
the device busy share, the top kernels by self device time, and the op
table.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 5


def static_step(tmp):
    """A closure that takes one static `train_step` on chip_smoke.py's
    static scene, from the store `gs_static` starts."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from vidu4d_tpu_torch import gs_static
    from vidu4d_tpu_torch.data.scene_readers import read_scene
    from vidu4d_tpu_torch.engine import gs_trainer
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.models.gaussian.optimizer import gs_adam_init

    cs.load_test_module("torch_parity").static_scene(
        tmp, np.random.default_rng(7), cs.STATIC_GT, cs.STATIC_INIT, cs.STATIC_CAMS,
        cs.STATIC_W, cs.STATIC_H, device="cuda")
    scene = read_scene(tmp)
    cam = gs_static.load_camera(scene.train_cameras[0], 1, "cuda")
    as_t = lambda a: torch.as_tensor(a, device="cuda")
    state = sf.init_from_points(as_t(scene.points), as_t(scene.colors), cs.STATIC_CAPACITY,
                                sh_degree=3, generator=torch.Generator("cuda").manual_seed(0))
    box = [state, gs_adam_init(state.params)]
    cfg = gs_trainer.GsTrainConfig()
    h, w = cam.image.shape[:2]

    def step():
        box[0], box[1], _ = gs_trainer.train_step(box[0], box[1], cam.viewmat, cam.intrins,
                                                  cam.image, h, w, 0, cfg)
    return step


def stage2_step(tmp, flags):
    """A closure that takes one Stage-2 `train_step` (batch read included)
    on chip_smoke.py's Stage-2 workload of ``flags``."""
    import chip_smoke as cs
    from vidu4d_tpu_torch import config
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
    from vidu4d_tpu_torch.models.fields.time_mlp import (
        init_camera_base_params,
        init_intrinsics_base_params,
    )

    db = cs.load_test_module("helpers").make_fake_db(tmp, num_vids=1, T=cs.S2_FRAMES,
                                                     H=cs.S2_RES, W=cs.S2_RES)
    opts = config.parse_flags(flags)
    opts.pop("device")
    trainer = Stage2Trainer({**opts, "dataroot": db, "logroot": tmp}, "cuda")
    model = trainer.model
    init_intrinsics_base_params(model.intrinsics, trainer.data_info["intrinsics"],
                                trainer.frame_info)
    for field in model.fields.values():
        init_camera_base_params(field.camera_mlp, trainer.rt_scaled, trainer.frame_info)
    return lambda: trainer.train_step()


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--reduced", action="store_true",
                      help="profile --nogs_optim_warp --rgb_loss_only --flow_wt 0")
    mode.add_argument("--static", action="store_true",
                      help="profile the static 2DGS step at 1237 x 822")
    mode.add_argument("--stage2", action="store_true",
                      help="profile the Stage-2 step of the README recipe")
    mode.add_argument("--stage2-comp", action="store_true",
                      help="profile the comp + skel-quad Stage-2 step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.gpu_name_and_power())
    print("configuration: " + ("static" if args.static else "stage2" if args.stage2
                               else "stage2-comp" if args.stage2_comp
                               else "reduced" if args.reduced else "default"))
    with tempfile.TemporaryDirectory() as tmp:
        if args.static:
            step = static_step(tmp)
        elif args.stage2 or args.stage2_comp:
            step = stage2_step(tmp, chip_smoke.S2C_FLAGS if args.stage2_comp
                               else chip_smoke.S2_FLAGS)
        else:
            trainer, batch = chip_smoke.build_trainer(tmp, "cuda", chip_smoke.MAIN_SURFELS,
                                                      chip_smoke.MAIN_RES,
                                                      reduced=args.reduced)
            step = lambda: trainer.train_step(batch)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    events = prof.key_averages()
    self_attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    # device busy time: the kernels' own events (the aten ops that launch
    # them report the same device time again, so they are not summed)
    kernels_ = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, self_attr) for e in kernels_) / 1e3 / STEPS
    print(f"[profile] wall {plain_wall_ms:.3f} ms/step without the profiler, "
          f"{wall_ms:.3f} with it; device busy {busy_ms:.3f} ms/step = "
          f"{busy_ms / plain_wall_ms:.3f} of the unprofiled step")
    for e in sorted(kernels_, key=lambda e: -getattr(e, self_attr))[:15]:
        print(f"[kernel] {getattr(e, self_attr) / 1e3 / STEPS:9.3f} ms/step "
              f"{e.count // STEPS:5d} launches/step  {e.key[:90]}")
    print(f"[memory] peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated")
    print(events.table(sort_by=self_attr, row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
