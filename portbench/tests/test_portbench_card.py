"""On the card (``-m cuda``), at each cell's own size: the program's checked
steps pass the cell's limits, and the control, the reference in the
precision below the configured one (TF32 matrix products for float32 with
TF32 off) put in the program's place, fails them, on three seeds."""

import os

import pytest
import torch

from portbench import compare, database, harness
from portbench.drivers import stage3
from portbench.tests.sizes import CELLS, ROOT

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def readings(cell, seed, tmp_path):
    """The program's gaps and the control's, against the float32 reference."""
    files = harness.cell_files(BENCH, cell)
    run = harness.make_run(files, seed, "cuda", str(tmp_path), {})
    run.db = database.write_database(str(tmp_path), seed, run.res, run.frames, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run.warmup_chunks = 1
    session = stage3.Session(run)
    prog = session.readings()
    state = session.state
    session.release()
    ref = stage3.reference(run, state, prog)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        control = stage3.reference(run, state, prog)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return compare.gaps(prog, ref), compare.gaps(control, ref), files["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202, 303])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_and_program_passes(cuda_device, cell, seed, tmp_path):
    prog, control, limits = readings(cell, seed, tmp_path)
    assert not compare.judge(control, limits), control
    assert compare.judge(prog, limits), prog
