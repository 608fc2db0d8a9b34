"""Per-field Adam for the surfel store
(`vidu4d_tpu/models/gaussian/optimizer.py`).

A minimal Adam (eps 1e-15, like the reference) whose moments mirror
SurfelParams; xyz uses the 3DGS exponential log-lerp schedule.
`gs_adam_update` updates the parameters and the moments IN PLACE (the JAX
version returns new trees): the surfel store is the largest state of the
step, and in-place updates keep one copy of it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams


class GsLearningRates(NamedTuple):
    """Defaults = reference `gs/arguments/__init__.py` OptimizationParams."""

    xyz_init: float = 0.00016
    xyz_final: float = 0.0000016
    xyz_delay_mult: float = 0.01
    xyz_max_steps: int = 30_000
    spatial_scale: float = 1.0
    features_dc: float = 0.0025
    features_rest: float = 0.0025 / 20.0
    opacity: float = 0.05
    scaling: float = 0.005
    rotation: float = 0.001
    regist_feat: float = 0.0


def expon_lr(step: float, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000) -> float:
    """3DGS log-lerp learning-rate schedule."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                        + math.log(max(lr_final, 1e-30)) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    return delay * log_lerp


def field_lrs(lrs: GsLearningRates, step: float) -> SurfelParams:
    """Per-field learning rates at ``step``, as a SurfelParams of floats."""
    xyz_lr = expon_lr(step, lrs.xyz_init * lrs.spatial_scale,
                      lrs.xyz_final * lrs.spatial_scale,
                      lr_delay_mult=lrs.xyz_delay_mult, max_steps=lrs.xyz_max_steps)
    return SurfelParams(
        xyz=xyz_lr, features_dc=lrs.features_dc, features_rest=lrs.features_rest,
        scaling=lrs.scaling, rotation=lrs.rotation, opacity=lrs.opacity,
        regist_feat=lrs.regist_feat,
    )


class GsAdamState(NamedTuple):
    count: int
    mu: SurfelParams
    nu: SurfelParams


def gs_adam_init(params: SurfelParams) -> GsAdamState:
    zeros = lambda: SurfelParams(*[torch.zeros_like(p, requires_grad=False)
                                   for p in params])
    return GsAdamState(count=0, mu=zeros(), nu=zeros())


@torch.no_grad()
def gs_adam_update(grads: SurfelParams, state: GsAdamState, params: SurfelParams,
                   lrs: GsLearningRates, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-15) -> GsAdamState:
    """One Adam step with per-field learning rates. Updates ``params`` and
    the moments in ``state`` in place and returns the state with the new
    count."""
    count = state.count + 1
    lr_tree = field_lrs(lrs, float(count))
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    for g, m, v, p, lr in zip(grads, state.mu, state.nu, params, lr_tree):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    return GsAdamState(count=count, mu=state.mu, nu=state.nu)
