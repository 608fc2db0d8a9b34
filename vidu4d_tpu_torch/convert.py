"""Convert the JAX package's parameters and state into the port's.

Inputs are numpy trees, as ``jax.tree.map(np.asarray, x)`` gives them:
the flax parameter dict of ``GaussianDeformer``, and the ``SurfelState`` /
``GsAdamState`` fields (any object with those attributes, or a dict). Such
arrays may share memory with live JAX buffers, so every leaf is copied.
This module imports neither jax nor the JAX package.

Flax ``Dense`` kernels are (in, out); ``nn.Linear`` weights are (out, in),
so kernels are transposed. Flax names the two layers of a compact ``Head``
``Dense_0`` (the output layer, created first) and ``Dense_1`` (the hidden
layer); the port names them ``out`` and ``hidden``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.models.gaussian.optimizer import GsAdamState
from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams, SurfelState

_RENAME = {"Dense_0": "out", "Dense_1": "hidden"}


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def flax_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """Flatten a flax ``{"params": {...}}`` tree into a torch state dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [_RENAME.get(k, k)])
            return
        arr = np.asarray(node, dtype=np.float32)
        if path[-1] == "kernel":
            path = path[:-1] + ["weight"]
            arr = arr.T
        out[".".join(path)] = torch.tensor(arr)

    walk(params.get("params", params), [])
    return out


def load_flax_params_(module: nn.Module, params: Dict) -> None:
    """Copy a flax parameter tree into ``module`` (strict: every parameter
    must be matched, and shapes must agree)."""
    sd = flax_to_state_dict(params)
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)


def surfel_state_from_jax(state: Any, device) -> SurfelState:
    """SurfelState fields (numpy) -> the port's SurfelState on ``device``;
    the parameter leaves require grad."""
    t = lambda a: torch.tensor(a, device=device)
    p = _field(state, "params")
    params = SurfelParams(*[
        t(np.asarray(_field(p, f), np.float32)).requires_grad_(True)
        for f in SurfelParams._fields
    ])
    return SurfelState(
        params=params,
        alive=t(np.asarray(_field(state, "alive"), bool)),
        max_radii2d=t(np.asarray(_field(state, "max_radii2d"), np.float32)),
        grad_accum=t(np.asarray(_field(state, "grad_accum"), np.float32)),
        denom=t(np.asarray(_field(state, "denom"), np.float32)),
    )


def gs_adam_from_jax(state: Any, device) -> GsAdamState:
    """GsAdamState fields (numpy) -> the port's GsAdamState on ``device``."""
    def tree(x):
        return SurfelParams(*[
            torch.tensor(np.asarray(_field(x, f), np.float32), device=device)
            for f in SurfelParams._fields
        ])
    return GsAdamState(count=int(np.asarray(_field(state, "count"))),
                       mu=tree(_field(state, "mu")), nu=tree(_field(state, "nu")))
