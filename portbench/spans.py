"""The program's spans (`vidu4d_tpu_torch.utils.profiler.span`) read two
ways: a `torch.profiler` trace of the profiled steps (`device`), where a
span is a host range ``vidu4d.<name>`` of the operator kind, and the
records of a `profiler.collect` collector over the window (`window`).

- `device`: per span name, the device µs of the operations launched
  inside it, on any thread (the backward runs on the autograd engine's
  thread inside ``s3.backward``), its children included, and its calls;
  ``warp_bwd_us``, the device µs of the backward nodes of the autograd
  nodes created inside ``warp`` spans (``warp_bwd_nodes``: their calls by
  node name); ``held_us`` of ``device_us``, the device µs inside any span
  of all the trace's device operations.
- `window`: the host's ms a step outside the batch read, and per batch
  the reads and the copies to the card.

An operation's device µs is ``op_us(event)`` of the host event that
launched it: by default the durations of the kernels, copies and fills
the trace links to it (`kernel_us`); any per-event time can stand in.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

from torch.autograd import DeviceType

PREFIX = "vidu4d."
RANGES = (PREFIX, "portbench.")
BACKWARD = "autograd::engine::evaluate_function: "


def kernel_us(e) -> float:
    """Device µs of the operations a host event launched (a user
    annotation's copy on the device's timeline, such as a ``portbench.``
    range's, is a device event of its own, linked to no host event)."""
    return sum(k.duration for k in e.kernels)


def _merge(ivals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, t in sorted(ivals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


class _Ops:
    """Host events with device time, by start, with prefix sums."""

    def __init__(self, ops):
        ops = sorted(ops, key=lambda o: o[0])
        self.starts = [s for s, _ in ops]
        self.cum = [0.0]
        for _, us in ops:
            self.cum.append(self.cum[-1] + us)

    def inside(self, ivals) -> float:
        """Device µs of the events that start inside the merged intervals."""
        total = 0.0
        for s, t in ivals:
            i = bisect.bisect_left(self.starts, s)
            j = bisect.bisect_right(self.starts, t)
            total += self.cum[j] - self.cum[i]
        return total


def _created(fwd: List, start: float, end: float) -> Tuple[int, int]:
    """The sequence numbers [lo, hi) of the autograd nodes that the forward
    ops ``fwd`` (one thread's (start, sequence_nr), by start) created in
    [start, end]: an op records the thread's next number, and a node takes
    it, so the numbers recorded inside run from the first node made inside
    to the next number read after."""
    starts = [s for s, _ in fwd]
    i, j = bisect.bisect_left(starts, start), bisect.bisect_right(starts, end)
    inside = [n for _, n in fwd[i:j]]
    if not inside:
        return 0, 0
    hi = fwd[j][1] if j < len(fwd) else max(inside) + 1
    return min(inside), hi


def device(events, op_us: Callable = kernel_us) -> Dict:
    """The trace's readings by span (the module's docstring)."""
    host = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    marks: Dict[str, List] = defaultdict(list)
    ops_any, ops_by_thread, fwd_by_thread = [], defaultdict(list), defaultdict(list)
    for e in host:
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(PREFIX):
            marks[e.name[len(PREFIX):]].append((e.thread, start, end))
            continue
        if e.name.startswith(RANGES):
            continue
        us = op_us(e)
        if us:
            ops_any.append((start, us))
            ops_by_thread[e.thread].append((start, us))
        if e.sequence_nr >= 0 and not e.fwd_thread and not e.name.startswith(BACKWARD):
            fwd_by_thread[e.thread].append((start, e.sequence_nr))
    ops = _Ops(ops_any)
    spans = {name: {"device_us": ops.inside(_merge([(s, t) for _, s, t in m])),
                    "calls": len(m)} for name, m in marks.items()}
    # the backward of the nodes made inside `warp`: (forward thread, number)
    made = defaultdict(list)
    fwd_by_thread = {t: sorted(f) for t, f in fwd_by_thread.items()}
    for thread, s, t in marks.get("warp", []):
        lo, hi = _created(fwd_by_thread.get(thread, []), s, t)
        if hi > lo:
            made[thread].append((lo, hi))
    by_thread = {t: _Ops(o) for t, o in ops_by_thread.items()}
    warp_bwd, nodes = 0.0, defaultdict(int)
    for e in host:
        if not e.name.startswith(BACKWARD) or e.thread not in by_thread:
            continue
        if any(lo <= e.sequence_nr < hi for lo, hi in made.get(e.fwd_thread, ())):
            warp_bwd += by_thread[e.thread].inside([(e.time_range.start, e.time_range.end)])
            nodes[e.name[len(BACKWARD):]] += 1
    every = _merge([(s, t) for m in marks.values() for _, s, t in m])
    return {"spans": spans, "warp_bwd_us": warp_bwd, "warp_bwd_nodes": dict(nodes),
            "held_us": ops.inside(every), "device_us": ops.cum[-1]}


def window(records) -> Dict:
    """From a collector's ``(name, parent, start_ns, end_ns)`` records:
    ``host_step_ms``, the mean of each ``s3.step`` less the ``data.batch``
    inside it; ``batch_read_ms``, the ``data.read`` inside each
    ``data.batch`` summed, the mean over batches; ``batch_copy_ms``, the
    mean of ``data.copy`` over batches; ``host_ms``, per span name its
    host ms summed over the window."""
    by: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for name, _, s, t in records:
        by[name].append((s, t))
    host_ms = {k: sum(t - s for s, t in v) / 1e6 for k, v in by.items()}

    def within(name, s, t):
        return sum(b - a for a, b in by[name] if s <= a and b <= t)

    mean = lambda xs: sum(xs) / 1e6 / len(xs) if xs else None
    batches = by["data.batch"]
    return {"host_step_ms": mean([t - s - within("data.batch", s, t) for s, t in by["s3.step"]]),
            "batch_read_ms": mean([within("data.read", s, t) for s, t in batches]),
            "batch_copy_ms": mean([within("data.copy", s, t) for s, t in batches]),
            "host_ms": host_ms}
