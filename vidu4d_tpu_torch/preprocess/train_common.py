"""What the three Stage-1 trainers (`train_raft`, `train_featnet`,
`train_depthnet`) share: the optax optimisers and schedules of the JAX
scripts as plain tensor math, flax's initialisers for the nets, where the
trainers write their weights, and the device check.

The JAX scripts train with
  - RAFT and DepthNet: ``optax.chain(clip_by_global_norm(1.0),
    adamw(linear_onecycle_schedule(steps, lr)))``;
  - FeatNet: ``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup,
    steps), weight_decay=1e-5)``;
with optax's defaults otherwise (b1 0.9, b2 0.999, eps 1e-8, weight decay
1e-4). The schedules are evaluated in float32, as optax evaluates them
(the one-cycle schedule is NaN for fewer than 4 steps in both packages:
two of its boundaries coincide), and Adam's bias corrections are rounded
in float32, as optax rounds them.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.engine.optim import B1, B2, EPS
from vidu4d_tpu_torch.preprocess.layers import REPO_ROOT

# where the trainers write their weights by default: outside the JAX
# package, whose shipped files the port's loaders read (`layers.weights_path`)
WEIGHTS_OUT = os.path.join(REPO_ROOT, "weights_out")


def linear_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, pct_final: float = 0.85,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Callable[[int], float]:
    """optax's ``linear_onecycle_schedule``: peak / div_factor rising to the
    peak at pct_start of the steps, back down at pct_final, then to
    peak / div_factor / final_div_factor at transition_steps (optax's
    ``piecewise_interpolate_schedule``, linear)."""
    if transition_steps <= 0:
        raise ValueError("linear_onecycle_schedule: transition_steps must be positive")
    scales = {int(pct_start * transition_steps): div_factor,
              int(pct_final * transition_steps): 1.0 / div_factor,
              transition_steps: 1.0 / final_div_factor}
    bounds, factors = zip(*sorted(scales.items()))
    bounds = np.asarray((0,) + bounds)
    values = np.cumprod(np.asarray((peak_value / div_factor,) + factors)).astype(np.float32)
    starts, sizes = bounds[:-1].astype(np.float32), (bounds[1:] - bounds[:-1]).astype(np.float32)

    def schedule(count: int) -> float:
        inside = ((bounds[:-1] <= count) & (count < bounds[1:])).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (np.float32(count) - starts) / sizes
            interp = (values[1:] - values[:-1]) * pct + values[:-1]
            return float(np.dot(inside, interp)
                         + np.float32(bounds[-1] <= count) * values[-1])

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from init_value to
    peak_value over warmup_steps, then a cosine decay to end_value at
    decay_steps (warm-up included)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("warmup_cosine_decay_schedule: decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float((f32(init_value) - f32(peak_value)) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps), dtype=f32))
        return float(f32(peak_value) * ((f32(1) - f32(alpha)) * decay + f32(alpha)))

    return schedule


class AdamW:
    """optax's ``adamw(schedule, weight_decay)``, after an optional
    ``clip_by_global_norm(clip_norm)`` (as ``optax.chain`` orders them),
    over ``params``. Every parameter is updated on every step, as optax
    updates every leaf (a missing ``.grad`` counts as zeros); ``count`` is
    the number of updates made, and the learning rate of an update is
    ``schedule(count)`` before it."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, clip_norm: Optional[float] = None):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p, requires_grad=False) for p in self.params]
        self.nu = [torch.zeros_like(p, requires_grad=False) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``. Returns the global
        norm of the gradients before clipping (a 0-d tensor)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if self.clip_norm is not None:
            keep = gnorm < self.clip_norm
            grads = [torch.where(keep, g, g / gnorm * self.clip_norm) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(B1) ** self.count)
        c2 = float(np.float32(1.0) - np.float32(B2) ** self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_((1.0 - B1) * g)
            v.mul_(B2).add_((1.0 - B2) * (g * g))
            u = (m / c1) / (torch.sqrt(v / c2) + EPS) + self.weight_decay * p
            p.sub_(lr * u)
        return gnorm


@torch.no_grad()
def flax_conv_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s parameters as flax initialises a conv net (the
    JAX scripts' ``model.init``): conv kernels lecun-normal (variance 1 /
    fan_in, a normal truncated at 2 sigma and rescaled), biases 0,
    GroupNorm scales 1 and offsets 0. All draws come from ``generator``."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return module


def train_device(name: str) -> torch.device:
    """The device a trainer runs on: the card unless "cpu" is asked for; a
    card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    return device


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def max_param_change(module: nn.Module, before) -> float:
    """The largest absolute change of any parameter since ``before`` (a list
    of the parameters' copies, in ``module.parameters()`` order)."""
    return max(float((p.detach() - b).abs().max()) for p, b in zip(module.parameters(), before))
