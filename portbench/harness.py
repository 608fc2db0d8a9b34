"""One run of one cell: set-up, the measured window, the traced steps, the
check against the plain reference, and the result's line.

Everything of a cell is found by the names in ``BENCHMARK.json``: the
configuration's file (its flags and options), the traffic mix
``portbench/traffic/<name>.json`` (the driver it runs, the step it starts
from and the optimisers' count there, the steps per call, the chunks of
warm-up and of the profiled steps, options over the configuration's), the
limits of the numbers compared ``portbench/limits/<cell>.json``, and each
per-layer metric's reader ``portbench/metrics/<name>.py``. A new cell or
metric is new files and entries only.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH_DIR = os.path.basename(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "vidu4d_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: Dict, cell: str, root: str = ROOT) -> Dict:
    """The cell's entry, its configuration's entry and file, its traffic
    file and its limits."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {"workload": w, "config": cfg,
            "config_file": load_json(os.path.join(root, cfg["file"])),
            "traffic": load_json(os.path.join(root, BENCH_DIR, "traffic", f"{w['traffic']}.json")),
            "limits": load_json(os.path.join(root, BENCH_DIR, "limits", f"{cell}.json"))}


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> str:
    """The card's name, power limit and clocks beside the window."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.mem,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def make_run(files: Dict, seed: int, device: str, work: str, overrides: Dict) -> SimpleNamespace:
    cfg, traffic = files["config_file"], files["traffic"]
    flags = list(cfg["flags"]) + list(traffic.get("flags", [])) + list(overrides.get("flags", []))
    opts = {**cfg.get("opts", {}), **traffic.get("opts", {}), **overrides.get("opts", {})}
    res = int(flags[len(flags) - 1 - flags[::-1].index("--train_res") + 1])
    return SimpleNamespace(
        flags=flags, opts=opts, res=res, device=device, seed=seed,
        seed31=seed % (2 ** 31 - 1), logroot=os.path.join(work, "logdir"),
        frames=overrides.get("frames", cfg["frames"]), chunk=traffic["chunk"],
        start=traffic["start_step"], opt_count=traffic.get("optimizer_count", traffic["start_step"]),
        warmup_chunks=traffic["warmup_chunks"],
        profile_chunks=traffic["profile_chunks"], fault=overrides.get("fault"),
        ref_fault=overrides.get("ref_fault"), db=None)


def run_cell(bench: Dict, cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", overrides: Optional[Dict] = None,
             root: str = ROOT) -> Dict:
    """One run of ``cell``; returns the result's dict (``checks`` last).
    ``overrides`` (tests): extra "flags" / "opts", "frames", a "fault"
    planted in the program, a "ref_fault" in the reference."""
    import torch

    from portbench import bounds, compare, database, trace as trace_mod
    from portbench.drivers import common

    overrides = overrides or {}
    files = cell_files(bench, cell, root)
    entry = files["workload"]
    driver = importlib.import_module(f"portbench.drivers.{files['traffic']['driver']}")
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        run = make_run(files, seed, device, work, overrides)
        run.db = database.write_database(work, seed, run.res, run.frames, device)
        session = driver.Session(run)
        log(f"[card] before the window: {nvidia_smi() if on_card else 'cpu'}")
        log(f"[probe] window start {json.dumps(session.probe())}")
        rec: Dict = {}
        common.sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        timers = session.window_timers(rec) if trace else contextlib.nullcontext()
        steps = 0
        with timers:
            t0 = time.perf_counter()
            while True:
                steps += session.chunk()
                if time.perf_counter() - t0 >= seconds:
                    break
            common.sync(device)
            window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        step_ms = window_s * 1e3 / steps
        log(f"[card] after the window: {nvidia_smi() if on_card else 'cpu'}")
        log(f"[probe] window end {json.dumps(session.probe())}")
        log(f"[window] {steps} steps in {window_s:.6f} s: {step_ms:.6f} ms/step; "
            f"set-up {setup_s:.3f} s; peak {peak} bytes")
        ctx = None
        if trace:
            with trace_mod.profile() as prof, session.profile_ranges(rec):
                tp0 = time.perf_counter()
                for _ in range(run.profile_chunks):
                    session.chunk()
                common.sync(device)
                profile_s = time.perf_counter() - tp0
            t_red = time.perf_counter()
            red = trace_mod.reduce(prof)
            del prof
            kernel_ms = session.kernel_ms(rec) if hasattr(session, "kernel_ms") else {}
            samples = [bounds.bounds_of(b) for b in rec.get("kernel_inputs", [])]
            rec.pop("kernel_inputs", None)
            log(f"[trace] reduced in {time.perf_counter() - t_red:.1f} s: "
                f"{json.dumps({k: v for k, v in red.items() if k != 'device_ops'})}")
            log(f"[bounds] {json.dumps(samples)} kernel ms {json.dumps(kernel_ms)}")
            ctx = {"steps": steps, "window_s": window_s, "step_ms": step_ms,
                   "profile_steps": run.profile_chunks * run.chunk, "profile_s": profile_s,
                   "profile": red, "bounds": samples, "kernel_ms": kernel_ms,
                   "peak_bytes": peak, **rec}
        prog = session.readings()
        failed = int(session.nonfinite) * run.chunk
        state = session.state
        session.release()
        del session
        ref = driver.reference(run, state, prog, flops=trace)
    values = compare.gaps(prog, ref)
    limits = files["limits"]
    log(f"[check] program {json.dumps(prog['loss'])} reference {json.dumps(ref['loss'])}")
    log(f"[check] densify: program {json.dumps(prog['densify'])} "
        f"reference {json.dumps(ref['densify'])}; worst leaves {compare.worst_leaves(prog, ref)}")
    correct = compare.judge(values, limits) and failed == 0
    result = {"correct": correct, "attempted": steps, "failed": failed}
    if trace:
        ctx["flops_per_step"] = ref["matmul_flops"] + (
            sum(s["tile_forward"]["ops"] + s["tile_backward"]["ops"] for s in ctx["bounds"])
            / len(ctx["bounds"]) if ctx["bounds"] else 0)
        metrics = {}
        for m in bench["per_layer"]:
            if cell not in m.get("workloads", [cell]):
                continue
            value = metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values_e2e = {"step_ms": step_ms, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values_e2e[m["name"]], "unit": m["unit"]}
                             for m in bench["end_to_end"]
                             if cell in m.get("workloads", [cell])}
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": torch.cuda.get_device_name() if on_card else "cpu",
                        "count": entry["chips"], "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=ctx["profile"]["busy_s"], window_s=ctx["profile_s"])
        result["breakdown"] = {"device_ops": ctx["profile"]["device_ops"],
                               "idle_gaps": ctx["profile"]["idle_gaps"]}
    for k, v in values.items():
        if k not in limits:
            log(f"[check] {k} {v!r} (not compared)")
    result["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = cell_files(bench, args.workload)["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        log(f"portbench: the process holds {found}: nothing the benchmark runs may load them")
        return 4
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
