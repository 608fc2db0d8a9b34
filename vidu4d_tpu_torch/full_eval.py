"""Benchmark-suite orchestrator of the static 2DGS pipeline
(`vidu4d_tpu/full_eval.py`, the reference's `gs/full_eval.py`).

Trains, renders and scores each scene of the standard collections
(MipNeRF-360, Tanks&Temples, Deep Blending) with the per-collection
downscale conventions (`gs/full_eval.py:15-52`: 4 for 360-outdoor, 2 for
360-indoor), in process through `gs_static.main`, and writes the last
history entry of every scene to ``results.json``:

    python -m vidu4d_tpu_torch.full_eval --mipnerf360 <dir> --tanksandtemples <dir> \\
        --deepblending <dir> --output_path ./eval [--skip_missing] [--device cpu]

Arguments it does not know are passed on to `gs_static.main`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def scene_jobs(m360: str, tat: str, db: str):
    """(scene, source_dir, downscale) per `gs/full_eval.py:40-52`."""
    jobs = [(s, os.path.join(m360, s), 4) for s in MIPNERF360_OUTDOOR]
    jobs += [(s, os.path.join(m360, s), 2) for s in MIPNERF360_INDOOR]
    jobs += [(s, os.path.join(tat, s), 1) for s in TANKS_AND_TEMPLES]
    jobs += [(s, os.path.join(db, s), 1) for s in DEEP_BLENDING]
    return jobs


def run_scene(scene: str, source: str, downscale: int, out_root: str,
              iterations: int, extra_argv=()) -> dict:
    """`gs_static.main` on one scene; returns its last history entry."""
    from vidu4d_tpu_torch import gs_static

    out_dir = os.path.join(out_root, scene)
    gs_static.main([
        f"--source_path_={source}", f"--model_path_={out_dir}",
        f"--downscale={downscale}", f"--iterations={iterations}", *extra_argv,
    ])
    with open(os.path.join(out_dir, "history.json")) as f:
        hist = json.load(f)
    return hist[-1] if hist else {}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mipnerf360", "-m360", default="")
    ap.add_argument("--tanksandtemples", "-tat", default="")
    ap.add_argument("--deepblending", "-db", default="")
    ap.add_argument("--output_path", default="./eval")
    ap.add_argument("--iterations", type=int, default=30_000)
    ap.add_argument("--skip_missing", action="store_true",
                    help="skip scenes whose source dir does not exist")
    args, extra = ap.parse_known_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    results = {}
    for scene, source, downscale in scene_jobs(args.mipnerf360, args.tanksandtemples,
                                               args.deepblending):
        if not os.path.isdir(source):
            if args.skip_missing:
                print(f"[skip] {scene}: {source} missing", file=sys.stderr)
                continue
            raise FileNotFoundError(f"{scene}: {source}")
        print(f"[train] {scene} (downscale {downscale})", flush=True)
        results[scene] = run_scene(scene, source, downscale, args.output_path,
                                   args.iterations, extra)
    with open(os.path.join(args.output_path, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
