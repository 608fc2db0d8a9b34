"""What a training driver uses: the program's options, its session's
base, `record_function` ranges, CUDA-event timing, and the faults that
the checks are shown to catch, planted in the program (the tests, on the
CPU; the calibration plants them in the reference put in the program's
place, `portbench.reference.stage3.replay`)."""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from portbench import database

MISSING = object()
SAMPLED_CALLS = 2  # forward-kernel calls whose inputs are kept for their bounds
FAULTS = ("frozen_state", "half_batch", "altered")


def trainer_opts(pkg, run) -> Dict:
    """A trainer's options: the CLI's defaults (``pkg.config``) under the
    run's flags and options, on the run's database and directories."""
    opts = pkg.config.parse_flags(run.flags)
    opts.pop("device", None)
    opts.update(run.opts)
    opts.update(dataroot=run.db, seqname=database.SEQ, logroot=run.logroot, seed=run.seed31)
    return opts


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def cuda_ms(fn: Callable, reps: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls in a
    row, after one call to warm up; None off the card."""
    if not torch.cuda.is_available():
        return None
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ranged(name: str, fn: Callable) -> Callable:
    """``fn`` inside a `record_function` range ``portbench.<name>``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(f"portbench.{name}"):
            return fn(*args, **kwargs)
    return wrapped


def unpatch(saved) -> None:
    """Undo ``(object, name, previous __dict__ entry or MISSING)``
    patches, last first."""
    for obj, name, prev in reversed(saved):
        if prev is MISSING:
            delattr(obj, name)
        else:
            setattr(obj, name, prev)


class Session:
    """Base of a driver's session: the run and a device count of the
    chunks whose last step's loss was not finite."""

    def __init__(self, run):
        self.run = run
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=run.device)


def plant(kind, pkg, trainer) -> Callable[[], None]:
    """Break the Stage-3 step underneath ``trainer`` (of the program's
    modules ``pkg``): ``frozen_state``, a step that leaves its state
    unchanged (both optimisers do nothing); ``half_batch``, the batch's
    second half replaced by its first, so that every mean is taken over
    half of it; ``altered``, the rendered colour made 1% brighter where it
    is produced (the forward compositor). Returns the undo."""
    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, obj.__dict__.get(name, MISSING)))
        setattr(obj, name, fn)

    if kind is None:
        pass
    elif kind == "frozen_state":
        patch(pkg.trainer, "gs_adam_update",
              lambda grads, state, params, lrs: state._replace(count=state.count + 1))
        patch(trainer.warp_opt, "step", lambda: None)
    elif kind == "half_batch":
        nxt = trainer._next_batch

        def half():
            batch = nxt()
            out = {}
            for k, v in batch.items():
                if v.ndim and v.shape[0] >= 2:
                    h = v.shape[0] // 2
                    v = torch.cat([v[:h], v[:h], v[2 * h:]])
                out[k] = v
            return out
        patch(trainer, "_next_batch", half)
    elif kind == "altered":
        fwd = pkg.tb.forward_tiles

        def brighter(*args, **kwargs):
            color, aux = fwd(*args, **kwargs)
            return color * 1.01, aux
        patch(pkg.tb, "forward_tiles", brighter)
    else:
        raise ValueError(f"unknown fault {kind!r}; known: {FAULTS}")
    return lambda: unpatch(saved)
