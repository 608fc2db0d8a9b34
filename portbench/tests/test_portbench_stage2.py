"""The Stage-2 cell ``s2-bob.train``: on the CPU at a small size (32^2
frames, 8 frames, 4 pairs x 4 pixels; the fields at their published
widths), the program's checked steps against the plain reference within
the cell's limits, each fault planted in the program caught, the cell and
its readers found from their files alone, and every new reader silent
(None, no error) on a program without the Stage-2 spans; on the card
(``-m cuda``), the cell at its own size: the program passes and the
control (the reference with TF32 matrix products) fails."""

import json
import os
import shutil
import time

import pytest
import torch

from portbench import compare, database, harness
from portbench.drivers import stage2
from portbench.drivers.common import FAULTS
from portbench.tests.sizes import ROOT

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "s2-bob.train"
SMALL = {"flags": ["--train_res", "32", "--imgs_per_gpu", "4", "--pixels_per_image", "4"],
         "frames": 8}
READERS = [m["name"] for m in BENCH["per_layer"] if m["name"].startswith("s2_")]
# every per-layer metric the cell reports (peak_gib reads the card's memory)
REPORTED = [m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [CELL])]


def readings(seed, device, tmp_path, overrides):
    """The program's gaps and the control's, against the float32 reference."""
    files = harness.cell_files(BENCH, CELL)
    run = harness.make_run(files, seed, device, str(tmp_path), overrides)
    run.db = database.write_database(str(tmp_path), seed, run.res, run.frames, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    run.warmup_chunks = 1
    session = stage2.Session(run)
    prog = session.readings()
    state = session.state
    session.release()
    ref = stage2.reference(run, state, prog)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = stage2.reference(run, state, prog)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return compare.gaps(prog, ref), compare.gaps(control, ref), files["limits"]


def test_reference_agrees_with_the_program_on_the_cpu(tmp_path):
    torch.set_num_threads(2)
    prog, _, limits = readings(2 ** 31 + 1919, "cpu", tmp_path, SMALL)
    assert compare.judge(prog, limits), prog
    assert prog["batch_gap"] == 0.0 and prog["loss_gap"] <= 1e-6


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    torch.set_num_threads(2)
    r = harness.run_cell(BENCH, CELL, 434343, 0.01, False, time.perf_counter(), "cpu",
                         {**SMALL, "fault": fault})
    assert r["correct"] is False, r["checks"]


def test_cell_runs_from_its_files_alone(tmp_path):
    """A checkout of the benchmark's files without the tests: the harness
    finds the cell's configuration, traffic, limits, driver and readers by
    their names, and a traced run reports every metric of the cell."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    bench = json.load(open(root / "BENCHMARK.json"))
    torch.set_num_threads(2)
    r = harness.run_cell(bench, CELL, 2 ** 31 + 7, 0.01, True, time.perf_counter(), "cpu",
                         SMALL, root=str(root))
    assert r["correct"] is True
    assert set(REPORTED) - {"peak_gib"} <= set(r["metrics"]), r["metrics"]
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap", "batch_gap",
                                "failed_steps"}


def test_readers_silent_without_the_spans():
    """A program without the Stage-2 spans: no collector records of them (or
    none at all) and no benchmark ranges; every reader returns None."""
    base = {"steps": 10, "step_ms": 700.0, "profile_steps": 5,
            "profile": {"ranges": {}, "kernels": 0, "busy_s": 0.0}}
    reads = [("data.read", None, 0, 5_000_000)] * 4
    for ctx in (base, {**base, "spans_host": []}, {**base, "spans_host": reads}):
        for name in READERS:
            assert harness.metric_reader(name)(ctx) is None, name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1901, 2 ** 31 + 1902])
def test_card_program_passes_control_fails(cuda_device, seed, tmp_path):
    prog, control, limits = readings(seed, cuda_device, tmp_path, {})
    assert compare.judge(prog, limits), prog
    assert not compare.judge(control, limits), control
