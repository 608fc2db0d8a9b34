"""(b) the reference agrees with the program's plain path, within the
cell's limits, on small steps on the CPU; (d) a cell and a per-layer metric added as new
files alone are found and run; (e) the result has the contract's keys; a
run without the card exits with no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import compare, harness
from portbench.drivers import stage3
from portbench.tests.sizes import CELLS, ROOT, SMALL

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(cell, tmp_path, seed=5):
    files = harness.cell_files(BENCH, cell)
    run = harness.make_run(files, seed, "cpu", str(tmp_path), SMALL[CELLS[cell]])
    from portbench import database
    run.db = database.write_database(str(tmp_path), seed, run.res, run.frames, "cpu")
    return run


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_agrees_with_the_programs_plain_path(cell, tmp_path):
    """Both sides from the benchmark's state, on the same frame pairs: the
    program's plain versions on the CPU and the reference agree within the
    cell's limits, and the first step's loss to a few float32 roundings."""
    torch.set_num_threads(2)
    run = small_run(cell, tmp_path)
    session = stage3.Session(run)
    prog = session.readings()
    state = session.state
    session.release()
    ref = stage3.reference(run, state, prog)
    values = compare.gaps(prog, ref)
    assert compare.judge(values, harness.cell_files(BENCH, cell)["limits"]), values
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-6 * abs(ref["loss"][0])
    assert values["batch_gap"] == 0.0


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_result_has_the_contract_keys(cell, trace):
    torch.set_num_threads(2)
    r = harness.run_cell(BENCH, cell, 2 ** 31 + 12345, 0.01, bool(trace), time.perf_counter(),
                         "cpu", SMALL[CELLS[cell]])
    keys = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    if trace:  # no device time or memory on the CPU: those readers return nothing
        want -= {"k1_roofline", "k2_roofline", "peak_gib"}
    assert set(r["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    dev = {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    assert set(r["device"]) == dev
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["checks"]) == set(harness.cell_files(BENCH, cell)["limits"]) | {"failed_steps"}
    assert {"loss_gap", "change_gap", "densify_gap", "batch_gap"} <= set(r["checks"])
    json.dumps(r)


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark's data with one more cell (its traffic and
    limits files) and one more per-layer metric (its reader): the harness
    runs the cell and reports the metric, with no code changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "reference", "tests"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.load(open(root / "portbench" / "traffic" / "s3.round5.json"))
    traffic.update(start_step=1497, why="a later window")
    json.dump(traffic, open(root / "portbench" / "traffic" / "s3.round7.json", "w"))
    shutil.copy(root / "portbench" / "limits" / "s3-gs-bob.train.json",
                root / "portbench" / "limits" / "s3-gs-bob.r7.json")
    (root / "portbench" / "metrics" / "alive_share.py").write_text(
        "def read(ctx):\n    return 100.0 * ctx['steps'] / ctx['steps']\n")
    bench["workloads"].append({"name": "s3-gs-bob.r7", "config": "vidu4d-s3-gs-bob",
                               "traffic": "s3.round7", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "alive_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "step_ms", "workloads": ["s3-gs-bob.r7"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    torch.set_num_threads(2)
    r = harness.run_cell(bench, "s3-gs-bob.r7", 9, 0.01, True, time.perf_counter(), "cpu",
                         SMALL["stage3"], root=str(root))
    assert r["correct"] is True
    assert r["metrics"]["alive_share"]["value"] == 100.0


def test_without_the_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this test is of a run without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", "s3-gs-bob.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
