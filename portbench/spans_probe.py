"""The program's spans on one cell, read with `portbench.spans` beside the
harness's own readings. No part of a cell's run, and no metric reads it.

    python3 portbench/spans_probe.py --workload <cell> --seed <n> --seconds <s> \
        [--rounds 2] [--tf32]

from the root of a checkout. After the cell's set-up, windows of
``--seconds`` in turns: tracing off, a `profiler.collect` collector on (the
spans' cost and the host's times), and the collector beside the harness's
window timers (``data.batch`` against `batch_ms`); with ``--tf32`` each
pair of turns is a collector window with FP32 matmuls, then one with TF32
(a stand-in for a faster warp GEMM: does `step_ms` follow the device?).
Then the traffic's
profiled chunk under the harness's profiler and ranges and a collector:
the harness's reduction (`portbench.trace`), the device ms of each span,
the warps' backward, what the spans hold of the busy time and of the
largest device operation, and the gap between a span's start as the
collector and as the trace saw it. Each window is a JSON line on standard
error; the whole is one JSON object, the last line of standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_portbench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from portbench import database, harness, spans, trace as trace_mod  # noqa: E402
from portbench.drivers import common  # noqa: E402
from vidu4d_tpu_torch.utils import profiler  # noqa: E402


def window(session, seconds: float, kind: str) -> dict:
    dev = session.run.device
    torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
    coll = contextlib.nullcontext([]) if kind == "off" else profiler.collect()
    rec: dict = {}
    timers = session.window_timers(rec) if kind == "timers" else contextlib.nullcontext()
    common.sync(dev)
    with timers, coll as records:
        t0, steps = time.perf_counter(), 0
        while True:
            steps += session.chunk()
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(dev)
        w = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"kind": kind, "steps": steps, "step_ms": w * 1e3 / steps}
    if records:
        read = spans.window(records)
        out.update({k: v for k, v in read.items() if k != "host_ms"})
        out["host_ms_per_step"] = {k: v / steps for k, v in read["host_ms"].items()}
    if rec.get("batch_s"):
        out["batch_ms"] = sum(rec["batch_s"]) * 1e3 / len(rec["batch_s"])
        out["data_batch_ms"] = statistics.mean(
            (t - s) / 1e6 for name, _, s, t in records if name == "data.batch")
    return out


def profiled(session) -> dict:
    run = session.run
    rec: dict = {}
    with trace_mod.profile() as prof, session.profile_ranges(rec), \
            profiler.collect() as records:
        t0 = time.perf_counter()
        for _ in range(run.profile_chunks):
            session.chunk()
        common.sync(run.device)
        profile_s = time.perf_counter() - t0
    steps = run.profile_chunks * run.chunk
    per_step = lambda us: us / 1e3 / steps
    red = trace_mod.reduce(prof)
    events = prof.events()
    by_span = spans.device(events)
    top = red["device_ops"][0][0] if red["device_ops"] else None
    top_by_span = spans.device(events, op_us=lambda e: sum(
        k.duration for k in e.kernels if k.name == top))
    span_us = lambda read, name: read["spans"].get(name, {}).get("device_us", 0.0)
    step_and_hooks = span_us(by_span, "s3.step") + span_us(by_span, "s3.hooks")
    # each span's start as the trace and as the collector saw it, in order
    traced = sorted(((e.name()[len(profiler.PREFIX):], e.start_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(profiler.PREFIX)
                     and e.device_type() == DeviceType.CPU), key=lambda r: r[1])
    taken = sorted(((r[0], r[2]) for r in records), key=lambda r: r[1])
    gaps = [abs(a[1] - b[1]) / 1e3 for a, b in zip(traced, taken)]
    busy_us = red["busy_s"] * 1e6
    return {
        "steps": steps, "wall_ms_per_step": profile_s * 1e3 / steps,
        "harness": {"launches_per_step": red["kernels"] / steps,
                    "idle_pct": 100.0 * (1.0 - red["busy_s"] / profile_s),
                    "busy_ms_per_step": per_step(busy_us),
                    "ranges_ms_per_step": {k: per_step(v["device_us"])
                                           for k, v in red["ranges"].items()},
                    "device_ops": red["device_ops"][:5], "idle_gaps": red["idle_gaps"][:5]},
        "span_events_on_device": sum(1 for e in events if e.device_type == DeviceType.CUDA
                                     and e.name.startswith(profiler.PREFIX)),
        "spans_ms_per_step": {k: per_step(v["device_us"]) for k, v in by_span["spans"].items()},
        "span_calls": {k: v["calls"] for k, v in by_span["spans"].items()},
        "bwd_ms": per_step(span_us(by_span, "s3.backward")),
        "warp_bwd_ms": per_step(by_span["warp_bwd_us"]),
        "warp_bwd_nodes": by_span["warp_bwd_nodes"],
        "step_and_hooks_of_busy": step_and_hooks / busy_us if busy_us else None,
        "top_op": top, "top_op_ms_per_step": per_step(top_by_span["device_us"]),
        "top_op_warp_fwd_ms": per_step(span_us(top_by_span, "warp")),
        "top_op_warp_bwd_ms": per_step(top_by_span["warp_bwd_us"]),
        "top_op_by_span_ms": {k: per_step(v["device_us"])
                              for k, v in top_by_span["spans"].items()},
        "clock": {"same_order": [r[0] for r in traced] == [r[0] for r in taken],
                  "median_start_gap_us": statistics.median(gaps) if gaps else None},
        "collector_under_profile": {k: v for k, v in spans.window(records).items()
                                    if k != "host_ms"},
    }


def probe(cell: str, seed: int, seconds: float, rounds: int = 2, tf32: bool = False,
          device: str = "cuda", overrides=None) -> dict:
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = harness.cell_files(bench, cell)
    driver = importlib.import_module(f"portbench.drivers.{files['traffic']['driver']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == "cuda"
    out = {"cell": cell, "seed": seed, "torch": torch.__version__,
           "card": harness.nvidia_smi() if on_card else "cpu", "windows": []}
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        run = harness.make_run(files, seed, device, work, overrides or {})
        run.db = database.write_database(work, seed, run.res, run.frames, device)
        session = driver.Session(run)
        out["setup_s"] = time.perf_counter() - T_START
        for kind in (["fp32", "tf32"] if tf32 else ["off", "collect", "timers"]) * rounds:
            out["windows"].append(window(session, seconds, kind))
            harness.log(json.dumps(out["windows"][-1]))
        out["profile"] = profiled(session)
        harness.log(json.dumps(out["profile"]))
        session.release()
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="The program's spans on one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tf32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("spans_probe: needs a CUDA device")
        return 3
    print(json.dumps(probe(args.workload, args.seed, args.seconds, args.rounds, args.tf32)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
