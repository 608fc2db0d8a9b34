"""AdamW of the warp / camera / intrinsics MLPs, and of the whole Stage-2
model (`vidu4d_tpu/engine/optim.py`).

The JAX package's optax chain, in its order, as plain tensor math:

  1. zero NaN gradients;
  2. clip the gradients to a global norm of 5;
  3. Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected);
  4. add weight decay 1e-4 x the parameter;
  5. x the per-parameter multiplier: x10 when any dotted-name part is in
     EXPLICIT_PARAM_NAMES, then x intrinsics_lr_mult under "intrinsics";
  6. x -onecycle_linear(count), count starting at 0 on the first update.

Every parameter is updated on every step, as optax updates every leaf: a
parameter without a gradient (``.grad is None``) takes a zero gradient and
is still weight-decayed (``torch.optim`` would skip it).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

EXPLICIT_PARAM_NAMES = (
    "logibeta", "logsigma", "logscale", "log_gauss", "base_quat",
    "base_logfocal", "base_ppoint", "trans_scaling", "bg_color",
)
EXPLICIT_MULT = 10.0
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4
GRAD_CLIP = 5.0


def lr_multiplier(name: str, intrinsics_mult: float = 1.0) -> float:
    """The learning-rate multiplier of a dotted parameter name."""
    parts = name.split(".")
    mult = EXPLICIT_MULT if any(k in EXPLICIT_PARAM_NAMES for k in parts) else 1.0
    if "intrinsics" in parts:
        mult = mult * intrinsics_mult
    return mult


def onecycle_linear(lr: float, total_steps: int, num_rounds: int):
    """Linear OneCycle: warm-up from lr / 25 over 2 rounds, then down to
    lr / 25 (`optim.py:62`, not resumed). Returns step -> learning rate."""
    initial = final = lr / 25.0
    warmup = max(int(total_steps * 2.0 / max(num_rounds, 2)), 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return initial + (lr - initial) * min(max(step / warmup, 0.0), 1.0)
        down_t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        return lr + (final - lr) * down_t

    return schedule


@torch.no_grad()
def adam_step_(params, grads, mu, nu, count: int, lr: float) -> None:
    """One step of optax's plain ``adam(lr)`` in place: ``count`` is the
    step's number from 1, bias corrections rounded in float32 as optax
    rounds them; a None gradient leaves its parameter and moments as they
    are (a zero gradient in optax, whose moments stay 0)."""
    c1 = float(np.float32(1.0) - np.float32(B1) ** count)
    c2 = float(np.float32(1.0) - np.float32(B2) ** count)
    for p, g, m, v in zip(params, grads, mu, nu):
        if g is None:
            continue
        m.mul_(B1).add_((1.0 - B1) * g)
        v.mul_(B2).add_((1.0 - B2) * (g * g))
        p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + EPS))


class WarpAdamW:
    """AdamW over named parameters with the JAX package's schedule and
    per-parameter multipliers. ``count`` is the number of updates made;
    ``mu`` / ``nu`` map each name to its moment."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 learning_rate: float, total_steps: int, num_rounds: int,
                 intrinsics_lr_mult: float = 1.0):
        self.params: Dict[str, torch.nn.Parameter] = dict(named_params)
        self.mult = {k: lr_multiplier(k, intrinsics_mult=intrinsics_lr_mult)
                     for k in self.params}
        self.schedule = onecycle_linear(learning_rate, total_steps, num_rounds)
        self.count = 0
        self.mu = {k: torch.zeros_like(p, requires_grad=False)
                   for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, requires_grad=False)
                   for k, p in self.params.items()}

    def load_state(self, state: Dict) -> None:
        """Take over {"count", "mu", "nu"} (per-name moments), e.g. from
        `vidu4d_tpu_torch.convert.warp_adamw_from_optax`."""
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.params):
                raise ValueError(f"{key} names differ from the parameters': "
                                 f"{sorted(set(state[key]) ^ set(self.params))}")
        self.count = int(state["count"])
        self.mu = {k: state["mu"][k].to(p.device) for k, p in self.params.items()}
        self.nu = {k: state["nu"][k].to(p.device) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None = zeros)."""
        grads = {}
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = torch.where(torch.isnan(g), 0.0, g)
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clip = gnorm >= GRAD_CLIP
        step_size = -self.schedule(self.count)
        self.count += 1
        # bias corrections in float32, as optax rounds them (1 - 0.999 is
        # 1.3e-5 off in float32)
        c1 = float(np.float32(1.0) - np.float32(B1) ** self.count)
        c2 = float(np.float32(1.0) - np.float32(B2) ** self.count)
        for k, p in self.params.items():
            g = torch.where(clip, grads[k] / gnorm * GRAD_CLIP, grads[k])
            m, v = self.mu[k], self.nu[k]
            m.mul_(B1).add_((1.0 - B1) * g)
            v.mul_(B2).add_((1.0 - B2) * (g * g))
            u = (m / c1) / (torch.sqrt(v / c2) + EPS) + WEIGHT_DECAY * p
            p.add_(u * (self.mult[k] * step_size))


def make_stage2_optimizer(model: torch.nn.Module, learning_rate: float, total_steps: int,
                          num_rounds: int, intrinsics_lr_mult: float = 1.0) -> WarpAdamW:
    """The Stage-2 optimiser (`optim.py:83`): the same chain as the warp
    AdamW, over every parameter of the Stage-2 model, by dotted name."""
    return WarpAdamW(model.named_parameters(), learning_rate=learning_rate,
                     total_steps=total_steps, num_rounds=num_rounds,
                     intrinsics_lr_mult=intrinsics_lr_mult)
