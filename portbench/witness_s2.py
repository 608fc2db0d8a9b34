"""A float64 witness of the Stage-2 cell's round-off, on the card:

    python3 portbench/witness_s2.py --seeds 1 2 3 [--out FILE]

For each seed, in one process: the program's checked steps (set-up and the
first chunk, as `calibrate.py` takes them) and the plain reference's, in
float32 and in float64, from the same state on the same batches and draws.
Prints one JSON line per seed: for each pair of sides (the program against
the float32 reference, the float64 reference against it, the program
against the float64 one) each step's relative loss gap and the median
leaf's change gap over the first update (``change_gap``, as the cell
compares it) and over all three steps (``change_gap_all``); and per step the
points whose skinning blend differs between the two references: a
different heaviest bone or a bone on the other side of its hemisphere
(``flips``), and those of them where the bones that changed side carry 1%
of the blend or more (``flips_1pct``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def recorded_blends(calls: list):
    """Each call of `nets.blend` appends (heaviest bone, hemisphere signs,
    weights) of its points, on the host."""
    import torch

    from portbench.reference import nets

    orig = nets.blend

    def blend(se3, x, weights):
        with torch.no_grad():
            arg = weights.argmax(-1)
            top = torch.gather(se3[0], 1, arg[..., None].expand(-1, -1, 4))
            sign = torch.einsum("mnd,mbd->mnb", top, se3[0]) > 0
            calls.append((arg.cpu(), sign.cpu(), weights.detach().half().cpu()))
        return orig(se3, x, weights)

    nets.blend = blend
    try:
        yield
    finally:
        nets.blend = orig


def flips(a: list, b: list, steps: int) -> dict:
    """Per step, the points whose blend differs between the two records."""
    per = len(a) // steps
    out = {"flips": [], "flips_1pct": [], "points": []}
    for s in range(steps):
        n = n1 = pts = 0
        for (arg_a, sign_a, _), (arg_b, sign_b, w_b) in zip(a[s * per:(s + 1) * per],
                                                            b[s * per:(s + 1) * per]):
            side = sign_a != sign_b
            moved = (w_b.float() * side).sum(-1)
            any_flip = (arg_a != arg_b) | side.any(-1)
            n += int(any_flip.sum())
            n1 += int((any_flip & ((arg_a != arg_b) | (moved >= 0.01))).sum())
            pts += arg_a.numel()
        out["flips"].append(n)
        out["flips_1pct"].append(n1)
        out["points"].append(pts)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="s2-bob.train")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--overrides", default="{}",
                    help="JSON of smaller sizes for a rehearsal on the CPU (`harness.run_cell`)")
    args = ap.parse_args(argv)
    import torch

    from portbench import compare, database, harness
    from portbench.drivers import common, stage2
    from portbench.reference import stage2 as ref2

    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = harness.cell_files(bench, args.workload)
    overrides = json.loads(args.overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    steps = compare.CHECKED_STEPS
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-wit-") as work:
            run = harness.make_run(files, seed, device, work, overrides)
            run.db = database.write_database(work, seed, run.res, run.frames, device)
            run.warmup_chunks = 1
            session = stage2.Session(run)
            prog = session.readings()
            state = session.state
            session.release()
            del session
            db = ref2.Pixels(run.db, database.SEQ, run.res, run.device)
            batches = [ref2.read_batch(db, b)[0] for b in prog["batches"]]
            sides, blends = {}, {}
            for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
                blends[name] = []
                with recorded_blends(blends[name]):
                    sides[name] = ref2.replay(db, state, batches, prog["draws"], run.frames,
                                              run.res, run.start, run.opt_count, steps,
                                              dtype=dtype)
                common.empty_cache(device)
        sides["program"] = prog
        line = {"workload": args.workload, "seed": seed}
        for a, b in (("program", "f32"), ("f64", "f32"), ("program", "f64")):
            g = compare.gaps(sides[a], sides[b])
            g_all = compare.gaps({**sides[a], "change": sides[a]["change_all"]},
                                 {**sides[b], "change": sides[b]["change_all"]})
            line[f"{a}_vs_{b}"] = {
                "steps": [abs(x / y - 1) for x, y in zip(sides[a]["loss"], sides[b]["loss"])],
                "loss_gap_all": g["loss_gap_all"], "grad_gap": g["grad_gap"],
                "change_gap": g["change_gap"], "change_gap_all": g_all["change_gap"]}
        line["blend_f32_vs_f64"] = flips(blends["f32"], blends["f64"], steps)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
