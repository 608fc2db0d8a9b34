"""(a) Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (``vidu4d_tpu_torch`` is not ``vidu4d_tpu``)."""

import ast
import os
import subprocess
import sys

from portbench.tests.sizes import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "vidu4d_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    bad = {p: imported_tops(p) & FORBIDDEN for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    bad = {p: t for p in sources("reference")
           if (t := imported_tops(p) & {"vidu4d_tpu_torch", "vidu4d_tpu", "jax", "flax"})}
    assert not bad
    # the import strings the program's modules would need, written any way
    for p in sources("reference"):
        assert "vidu4d_tpu_torch" not in open(p).read(), p


def test_a_run_loads_no_jax():
    """A whole small run of each cell in a fresh process, then its
    sys.modules by top-level name."""
    code = (
        "import sys, time, json; t0 = time.perf_counter(); sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from portbench import harness; from portbench.tests.sizes import SMALL\n"
        "b = harness.load_json(%r)\n"
        "for cell in ('s3-gs-bob.train', 's3-gs-bob.late'):\n"
        "    r = harness.run_cell(b, cell, 7, 0.01, False, t0, 'cpu', SMALL['stage3'])\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        % (ROOT, os.path.join(ROOT, "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
