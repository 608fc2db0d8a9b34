"""The check sees each fault a training cell can have: a run, with the
card's look skipped and the timed path broken underneath (planted in the
program), comes out not correct. One cell has one chip, so no exchange
between chips can be left out."""

import os
import time

import pytest
import torch

from portbench import harness
from portbench.drivers.common import FAULTS
from portbench.tests.sizes import CELLS, ROOT, SMALL

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault):
    torch.set_num_threads(2)
    r = harness.run_cell(BENCH, cell, 424242, 0.01, False, time.perf_counter(), "cpu",
                         {**SMALL[CELLS[cell]], "fault": fault})
    assert r["correct"] is False, r["checks"]
