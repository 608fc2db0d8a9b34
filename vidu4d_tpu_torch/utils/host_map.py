"""Host-side work splitting and parallel map (`vidu4d_tpu/utils/host_map.py`).

Replaces `lab4d/utils/gpu_utils.py` gpu_map (the Stage-1 process farm) and
`scripts/run_rendering_parallel.py`. A "host" is a node: in a run over
several nodes each takes its slice of a work list by its node index; the
ranks of one node (the command line's ``--ngpu`` spawn) are one host, and
draw as the JAX package's one process does. Single-host runs can use
thread or process pools for IO-bound work (video decode, npy writing).
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing as mp
import os
from typing import Callable, List, Sequence


def node_index() -> int:
    """This node's index: ``GROUP_RANK`` (torchrun's node rank), else
    ``RANK // LOCAL_WORLD_SIZE``, else 0 (no launcher, or one node)."""
    if "GROUP_RANK" in os.environ:
        return int(os.environ["GROUP_RANK"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    return int(os.environ.get("RANK", "0")) // local if local else 0


def node_count() -> int:
    """The number of nodes: ``WORLD_SIZE // LOCAL_WORLD_SIZE`` under a
    launcher, else 1."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    return max(int(os.environ.get("WORLD_SIZE", "1")) // local, 1) if local else 1


def host_slice(items: Sequence, process_index: int = None,
               process_count: int = None) -> List:
    """The current host's shard of a work list (SURVEY §2.2: DistributedSampler
    becomes per-host slicing of the index space)."""
    pi = node_index() if process_index is None else process_index
    pc = node_count() if process_count is None else process_count
    return list(items)[pi::pc]


def host_map(func: Callable, args_list: Sequence, method: str = "thread",
             max_workers: int = 8) -> List:
    """Parallel map for IO-bound per-video work (`gpu_utils.py:6-128`).

    method: "thread" (default), "process" (spawn; for pure-python CPU
    work), or "sequential".
    """
    if method == "sequential" or len(args_list) <= 1:
        return [func(*a) if isinstance(a, tuple) else func(a) for a in args_list]
    if method == "process":
        ctx = mp.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
            max_workers=max_workers, mp_context=ctx
        ) as pool:
            futs = [
                pool.submit(func, *a) if isinstance(a, tuple) else pool.submit(func, a)
                for a in args_list
            ]
            return [f.result() for f in futs]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futs = [
            pool.submit(func, *a) if isinstance(a, tuple) else pool.submit(func, a)
            for a in args_list
        ]
        return [f.result() for f in futs]
