"""Tracing of the port: per-round profiler traces (`round_trace`, after
`vidu4d_tpu/utils/profiler.py`) and the spans that name the port's own
layers (`span`, `collect`).

A span is on exactly when a `torch.profiler` is recording or a `collect`
collector is installed; otherwise it costs one check. Under a profiler it
is a host range ``vidu4d.<name>`` of the operator kind (`_range`), which
holds the operations launched inside it as an operator holds its kernels.
It is not a ``record_function`` range: the card's trace repeats a user
annotation on the device's timeline as an event spanning its kernels,
which a reduction of that timeline would count as a device operation of
the range's whole length. Under a collector it is a record ``(name,
parent, start_ns, end_ns)``: ``parent`` is the enclosing span's name on
the same thread (None at the top), and the times are read on the
profiler's clock (`clock_ns`), so a span taken without a profiler lies on
the same timeline as a trace's events (a trace's event times are offsets
from ``prof.profiler.kineto_results.trace_start_ns()``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import List, Optional, Tuple

import torch

PREFIX = "vidu4d."

Record = Tuple[str, Optional[str], int, int]

# torch's profiler stamps its events in Unix time (CLOCK_REALTIME on
# Linux), not on time.perf_counter's CLOCK_MONOTONIC
clock_ns = time.time_ns

# a RecordFunction of the operator scope: traced as a ``cpu_op``, where
# `torch.profiler.record_function` is a ``user_annotation``
_range = torch._C._profiler._RecordFunctionFast

_collector: Optional[List[Record]] = None
_local = threading.local()


def _tracing() -> bool:
    return _collector is not None or torch.autograd._profiler_enabled()


class span:
    """``with span("s3.backward"): ...`` or ``@span("warp")``: the work
    inside, named for a profiler or a collector when either is on. A span
    object is entered once at a time; a decorated call makes its own."""

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _tracing():
                return fn(*args, **kwargs)
            with span(self.name):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        if not _tracing():
            return self
        stack = _local.__dict__.setdefault("stack", [])
        rf = None
        if torch.autograd._profiler_enabled():
            rf = _range(PREFIX + self.name)
        sink = _collector
        parent = stack[-1] if stack else None
        start = clock_ns() if sink is not None else 0
        if rf is not None:
            rf.__enter__()
        stack.append(self.name)
        self._open = (rf, sink, parent, start)
        return self

    def __exit__(self, *exc):
        if self._open is None:
            return False
        rf, sink, parent, start = self._open
        self._open = None
        _local.stack.pop()
        if rf is not None:
            rf.__exit__(*exc)
        if sink is not None:
            sink.append((self.name, parent, start, clock_ns()))
        return False


@contextlib.contextmanager
def collect():
    """Install an in-memory collector and yield its list of span records,
    filled as spans close; the previous collector comes back after."""
    global _collector
    prev, records = _collector, []
    _collector = records
    try:
        yield records
    finally:
        _collector = prev


@contextlib.contextmanager
def round_trace(logdir: str, round_idx: int, enabled: bool = True, device=None):
    """Trace one training round into a Chrome trace,
    ``<logdir>/traces/round_NNN/trace.json``: host activity with the
    port's ``vidu4d.*`` spans, and the card's when ``device`` is a CUDA
    device."""
    if not enabled:
        yield
        return
    trace_dir = os.path.join(logdir, "traces", f"round_{round_idx:03d}")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
