"""Reduction of a `torch.profiler` trace of the profiled steps.

- ``ranges``: per benchmark range (`record_function` names starting with
  ``portbench.``), the device time of the operations launched inside it
  and its calls;
- ``kernels``: device kernels launched (memory copies and fills are
  device operations but not launches);
- ``busy_s``: the union of every device operation's interval;
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the device's idle gaps, each of the 300 longest put to what
  the host was doing at its middle (the innermost host event spanning
  it; "(host between operations)" where none spans it), the ten largest
  sums.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import DeviceType

PREFIX = "portbench."


def _device_attr(evt) -> str:
    return "self_device_time_total" if hasattr(evt, "self_device_time_total") \
        else "self_cuda_time_total"


def reduce(prof) -> Dict:
    events = prof.events()
    # the benchmark's ranges also appear on the device's timeline (as
    # annotations spanning their kernels): they are not device operations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(PREFIX)]
    host = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    ranges: Dict[str, Dict] = defaultdict(lambda: {"device_us": 0.0, "calls": 0})
    for e in host:
        if e.name.startswith(PREFIX):
            r = ranges[e.name[len(PREFIX):]]
            r["device_us"] += e.device_time_total
            r["calls"] += 1
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    ivals = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged = []
    for s, t in ivals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    by_op: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_op[e.name] += e.time_range.end - e.time_range.start
    # idle gaps between merged device intervals, by the host's innermost event
    gaps = [(merged[i + 1][0] - merged[i][1], (merged[i][1] + merged[i + 1][0]) / 2)
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    host_sorted = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host_sorted]
    by_gap: Dict[str, float] = defaultdict(float)
    for length, mid in gaps[:300]:
        i = bisect.bisect_right(starts, mid)
        best = None
        for e in reversed(host_sorted[max(0, i - 3000):i]):
            if e.time_range.end >= mid and (best is None or
                                            e.time_range.end - e.time_range.start
                                            < best.time_range.end - best.time_range.start):
                best = e
        by_gap[best.name if best is not None else "(host between operations)"] += length
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"ranges": {k: dict(v) for k, v in ranges.items()},
            "kernels": len(kernels), "busy_s": busy_us / 1e6,
            "device_ops": top(by_op), "idle_gaps": top(by_gap)}


def profile():
    """A profiler of the host and the card."""
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
