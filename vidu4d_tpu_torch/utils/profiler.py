"""Per-round profiler traces (`vidu4d_tpu/utils/profiler.py`) on
``torch.profiler``."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def round_trace(logdir: str, round_idx: int, enabled: bool = True, device=None):
    """Trace one training round into a Chrome trace,
    ``<logdir>/traces/round_NNN/trace.json``: host activity, and the
    card's when ``device`` is a CUDA device."""
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
