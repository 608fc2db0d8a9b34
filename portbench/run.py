"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result's JSON object as the last
line of standard output, and each number compared beside its limit as the
last lines of standard error. Exits non-zero, with no result, without the
CUDA devices the cell needs.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of a run at a fixed path inside the checkout (ignored by git)
CACHE = os.path.join(ROOT, "_portbench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
