"""What decides ``correct`` for a training cell.

Set-up drives the program's trainer through its first steps (the window's
own call and feed); after the window the plain reference
(`portbench.reference`) takes the first ``CHECKED_STEPS`` of them from the
same initial state, on the same frame pairs, read from the database by
itself. The program is read by `Capture`, the reference reports the same:

- ``loss``: each checked step's total loss;
- ``grad``: per leaf, the norm of the first gradient as the optimiser got
  it (the program's worked out from its first moment after one step: the
  moments start at 0, so mu = (1 - b1) g);
- ``change``: per leaf, the norm of the parameters' change over the
  checked steps as the next step finds it, the densify that fires after
  the last checked step included.

`gaps` turns two readings into the numbers compared:

- ``loss_gap``: the first step's loss, relative;
- ``grad_gap``, ``change_gap``: the median leaf's gap of first-gradient
  norms, and of change norms as the next step finds them, each against
  the larger of the reference leaf's norm and the median leaf's;
- ``batch_gap``: the largest difference between the program's batches and
  the same frame pairs read by the reference (infinite for a pair the
  loader cannot draw);
- ``densify_gap`` (`drivers.stage3.densify_check`): the program's densify
  hook and the reference's run on the same store, the reference's just
  before its densify fired: the largest difference of what they leave.

A cell's limits file names the numbers it compares (the late cell's has
no ``grad_gap``: a seed whose float32 gradient is ill-conditioned reads
it above the control's smallest reading). Printed beside them, not
compared: every step's loss (``loss_gap_all``)
and the worst leaf's gradient and change (``grad_gap_worst``,
``change_gap_worst``). They swing from seed to seed with round-off: the
float32 gradient of the surfel positions and of the camera's quaternion
bias is ill-conditioned (a float64 witness puts the float32 reference as
far from it, 1-5%, as the program), a change of ~1e-3 on the principal
point (~128) is stored to one float32 ulp (1.5e-5) per update, the
densify clones a surfel whose mean screen gradient lies within round-off
of the threshold on one side only, and in a store at its entry cap the
binning's 128-slot tile segments cut a whole block of entries on one side
only; steps 2 and 3 carry all of it. Leaves whose reference gradient is
under a thousandth of the median leaf's (the skinning temperature, which
no term reads) move by weight decay and round-off alone and are left out
of the change.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

CHECKED_STEPS = 3
B1 = 0.9  # both optimisers' first-moment decay
ZERO_GRAD_SHARE = 1e-3


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.detach().double())


class Capture:
    """Reads the program's checked steps by wrapping its trainer's
    ``train_step`` (an instance attribute, removed by `close`).

    ``leaves()`` -> {name: parameter tensor} (read anew at each use: hooks
    may replace the store); ``moments()`` -> {name: first moment};
    ``initial`` -> {name: tensor} of the parameters before the first
    step (on any device)."""

    def __init__(self, trainer, leaves: Callable[[], Dict], moments: Callable[[], Dict],
                 initial: Dict[str, torch.Tensor]):
        self.trainer = trainer
        self.leaves, self.moments, self.initial = leaves, moments, initial
        self.calls = 0
        self.loss: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}
        self._orig = trainer.train_step
        trainer.train_step = self._step

    def _step(self, *args, **kwargs):
        if self.calls == CHECKED_STEPS:
            self.take_change()
        out = self._orig(*args, **kwargs)
        self.calls += 1
        if self.calls <= CHECKED_STEPS:
            self.loss.append(out["total"].detach().double())
        if self.calls == 1:
            self.grad = {k: _norm(m) / (1.0 - B1) for k, m in self.moments().items()}
        return out

    def take_change(self) -> None:
        """The change as the next step finds it (once; frees the copy)."""
        if self.change:
            return
        with torch.no_grad():
            self.change = {k: _norm(p.double() - self.initial[k].to(p.device).double())
                           for k, p in self.leaves().items()}
        self.initial = None

    def close(self) -> None:
        if "train_step" in self.trainer.__dict__:
            del self.trainer.train_step

    def readings(self) -> Dict:
        """Host floats (synchronises)."""
        if len(self.loss) < CHECKED_STEPS or not self.change:
            raise RuntimeError(f"the checked steps did not all run ({len(self.loss)} "
                               f"losses, change taken: {bool(self.change)})")
        host = lambda d: {k: float(v) for k, v in d.items()}
        return {"loss": [float(x) for x in self.loss], "grad": host(self.grad),
                "change": host(self.change)}


def _leaf_gaps(prog: Dict, ref: Dict):
    if set(prog["grad"]) != set(ref["grad"]) or set(prog["change"]) != set(ref["change"]):
        raise ValueError("the two sides' leaves differ: "
                         f"{sorted(set(prog['grad']) ^ set(ref['grad']))}")
    g_ref = ref["grad"]
    g_med = float(np.median(list(g_ref.values())))
    grad = {k: abs(prog["grad"][k] - g_ref[k]) / max(g_ref[k], g_med, 1e-30) for k in g_ref}
    kept = [k for k in ref["change"] if g_ref.get(k, 0.0) >= ZERO_GRAD_SHARE * g_med]
    c_med = float(np.median([ref["change"][k] for k in kept]))
    change = {k: abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med, 1e-30)
              for k in kept}
    return grad, change


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared (see the module's docstring), and those printed
    beside them; NaN where a side read a non-finite number, which no limit
    passes."""
    grad, change = _leaf_gaps(prog, ref)
    rel = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]
    out = {"loss_gap": rel[0], "grad_gap": float(np.median(list(grad.values()))),
           "change_gap": float(np.median(list(change.values()))),
           "densify_gap": ref.get("densify_gap", 0.0), "batch_gap": ref.get("batch_gap", 0.0),
           "loss_gap_all": max(rel), "grad_gap_worst": max(grad.values()),
           "change_gap_worst": max(change.values())}
    every = [*prog["loss"], *prog["grad"].values(), *prog["change"].values()]
    if not all(math.isfinite(v) for v in every):
        out = {k: float("nan") for k in out}
    return out


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaves that set the worst gradient and change gaps."""
    grad, change = _leaf_gaps(prog, ref)
    return {"grad": max(grad, key=grad.get), "change": max(change, key=change.get)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared within its limit (NaN passes none)."""
    return all(values[k] <= limits[k] for k in limits)
