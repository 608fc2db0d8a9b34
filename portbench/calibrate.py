"""The readings that a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--variants ...]

For each seed, in one process: the program's checked steps (set-up and the
first chunk, as a run takes them) and the plain reference's, and the
reference again with a variant in the program's place: ``control``, the
reference with TF32 matrix products (the precision below the configured
float32 with TF32 off), and the faults planted in it (``half_batch``,
``altered``; ``frozen_state`` reads 1 by construction).
Prints one JSON line per seed and variant with the numbers compared
(`compare.gaps` against the float32 reference), and writes them to
``--out`` too.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="*", default=["program", "control", "half_batch",
                                                       "altered"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--overrides", default="{}",
                    help="JSON of smaller sizes for a rehearsal on the CPU (`harness.run_cell`)")
    args = ap.parse_args(argv)
    import torch

    from portbench import compare, database, harness

    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = harness.cell_files(bench, args.workload)
    driver = importlib.import_module(f"portbench.drivers.{files['traffic']['driver']}")
    overrides = json.loads(args.overrides)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-cal-") as work:
            run = harness.make_run(files, seed, device, work, overrides)
            run.db = database.write_database(work, seed, run.res, run.frames, device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            run.warmup_chunks = 1
            session = driver.Session(run)
            prog = session.readings()
            state = session.state
            session.release()
            del session
            ref = driver.reference(run, state, prog)
            rows = [("program", prog)] if "program" in args.variants else []
            for v in args.variants:
                if v == "program":
                    continue
                if v == "control":
                    torch.backends.cuda.matmul.allow_tf32 = True
                    torch.backends.cudnn.allow_tf32 = True
                    try:
                        rows.append((v, driver.reference(run, state, prog)))
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                        torch.backends.cudnn.allow_tf32 = False
                else:
                    run.ref_fault = v
                    try:
                        rows.append((v, driver.reference(run, state, prog)))
                    finally:
                        run.ref_fault = None
        for v, r in rows:
            line = {"workload": args.workload, "seed": seed, "variant": v,
                    **compare.gaps(r, ref), "worst": compare.worst_leaves(r, ref),
                    "steps": [abs(a / b - 1) for a, b in zip(r["loss"], ref["loss"])],
                    "loss": r["loss"], "ref_loss": ref["loss"],
                    "densify": r.get("densify"), "ref_densify": ref["densify"]}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        print(f"[seed {seed}] {time.perf_counter() - t0:.1f} s", flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
