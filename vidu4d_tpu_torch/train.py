"""Training entry point (`vidu4d_tpu/train.py`), Stage 2 and Stage 3.

    python -m vidu4d_tpu_torch.train --seqname cheetah --logname s2 --fg_motion bob \\
        --num_rounds 21 --rgb_timefree --rgb_dirfree [--device cpu]
    python -m vidu4d_tpu_torch.train --seqname cheetah --logname s3 --fg_motion gs-bob \\
        --num_rounds 61 --imgs_per_gpu 1 --pixels_per_image -1 \\
        --load_path logdir/cheetah-s2/ckpt_latest.pth \\
        --gs_init_mesh logdir/cheetah-s2/020-fg-geo.obj [--device cpu]

Writes ``<logroot>/<seqname>-<logname>/opts.log`` (readable by the JAX
CLIs). Stage 3 (a "gs" ``fg_motion``) starts the surfels on
``--gs_init_mesh`` and takes the warp, cameras and intrinsics over from the
Stage-2 checkpoint ``--load_path`` (the port's or a JAX file, read without
JAX); Stage 2 runs `mlp_init`. Either resumes from
``ckpt_<load_suffix>.pth`` when ``--load_suffix`` is set (Stage 2 then
skips `mlp_init`), and trains. Runs on the card unless ``--device cpu``.

``--ngpu N`` trains data-parallel over N ranks (`parallel.sharding`): it
spawns N processes, rank r on card r over NCCL (more than the visible
cards raise ValueError), or on the CPU over gloo with ``--device cpu``;
under a launcher that sets ``RANK`` / ``WORLD_SIZE`` (torchrun) each
process joins that group instead. Rank 0 alone writes and prints.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence

from vidu4d_tpu_torch import config
from vidu4d_tpu_torch.parallel import sharding


def log_fn(step: int, scalars: Dict[str, float]) -> None:
    """The JAX CLI's console line: ``step N: k=v ...``, the 8 largest terms."""
    top = sorted(scalars.items(), key=lambda kv: -abs(float(kv[1])))[:8]
    print(f"step {step}: " + " ".join(f"{k}={float(v):.4f}" for k, v in top))


def main(argv: Optional[Sequence[str]] = None):
    """Parse, save opts.log, build the trainer, load, train. Returns the
    trainer; with ``--ngpu`` > 1 spawned here, None (the trainers live in
    the ranks)."""
    opts = config.parse_flags(sys.argv[1:] if argv is None else argv)
    device = opts.pop("device")
    ngpu = opts["ngpu"] or 1
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if int(os.environ.get("RANK", "0")) == 0:
        config.save_config(opts)
    if ngpu > 1 and not launched:
        sharding.check_cards(ngpu, device)
        sharding.spawn(_train_rank, ngpu, args=(opts,), device=device)
        return None
    group = None
    if ngpu > 1:
        group = sharding.make_mesh(ngpu, device=device)
        device = group.device
        if device.type == "cuda":
            import torch

            torch.cuda.set_device(device)
    return run(opts, device, group)


def _train_rank(mesh: sharding.Mesh, opts) -> None:
    run(opts, mesh.device, mesh)


def run(opts, device, group: Optional[sharding.Mesh] = None):
    """Build the trainer of ``opts`` on ``device`` (one rank of ``group``),
    load, train. Returns the trainer."""
    stage3 = "gs" in opts["fg_motion"]
    if stage3:
        from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer

        trainer = Stage3Trainer(opts, device, group=group)
        if opts["load_path"]:
            trainer.load_stage2(opts["load_path"])
    else:
        from vidu4d_tpu_torch.engine.trainer import Stage2Trainer

        trainer = Stage2Trainer(opts, device, group=group)
    if opts["load_suffix"]:
        trainer.load_checkpoint(
            os.path.join(trainer.save_dir, f"ckpt_{opts['load_suffix']}.pth"),
            reset_steps=opts["reset_steps"])
    elif not stage3:
        trainer.mlp_init()
    trainer.train(log_fn=log_fn)
    return trainer


if __name__ == "__main__":
    main()
