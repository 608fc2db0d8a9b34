"""Profile the port's Stage-3 step on one CUDA GPU with torch.profiler.

    python3 scripts/profile_torch_step.py [--reduced]

Builds the chip_smoke.py workload (200k surfels, 256x256, 2 frames;
calibrated cloud, one fixed batch) in the default configuration (with
--reduced: --nogs_optim_warp --rgb_loss_only --flow_wt 0), warms up, then
profiles a few steps.
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="profile --nogs_optim_warp --rgb_loss_only --flow_wt 0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.gpu_name_and_power())
    print(f"configuration: {'reduced' if args.reduced else 'default'}")
    with tempfile.TemporaryDirectory() as tmp:
        trainer, batch = chip_smoke.build_trainer(tmp, "cuda", chip_smoke.MAIN_SURFELS,
                                                  chip_smoke.MAIN_RES, reduced=args.reduced)
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                trainer.train_step(batch)
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
    print(events.table(sort_by=self_attr, row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
