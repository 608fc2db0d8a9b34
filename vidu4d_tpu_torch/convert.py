"""Convert the JAX package's parameters, state and checkpoints into the
port's.

`load_jax_checkpoint` reads a JAX ``ckpt_*.pth`` without importing JAX:
its pickles hold classes of the JAX package, of optax and of flax. Other
inputs are numpy trees, as ``jax.tree.map(np.asarray, x)`` gives them:
the flax parameter dict of ``GaussianDeformer`` or of the Stage-2
``DvrModel`` (whose ``fields_fg`` / ``fields_bg`` subtrees are the port's
``fields.fg`` / ``fields.bg``),
the ``SurfelState`` / ``GsAdamState`` fields (any object with those
attributes, or a dict), and the optax state of the warp AdamW or of the
Stage-2 optimiser. Such
arrays may share memory with live JAX buffers, so every leaf is copied.
This module imports neither jax nor the JAX package.

The shipped Stage-1 nets (``vidu4d_tpu/weights/*.npz``: RAFT-small,
DepthNet, FeatNet, flax conv nets flattened with "/") map onto the port's
modules by `flax_conv_net_state_dict`, and back by `flax_conv_net_flat`.

Flax ``Dense`` kernels are (in, out); ``nn.Linear`` weights are (out, in),
so kernels are transposed. Flax names the two layers of a compact ``Head``
``Dense_0`` (the output layer, created first) and ``Dense_1`` (the hidden
layer); the port names them ``out`` and ``hidden``. The rename applies to
a ``Head`` only, a node whose children are exactly ``Dense_0`` and
``Dense_1``: the compact NVP coupling's ``Dense_0`` .. ``Dense_2`` are its
hidden, hidden and output layers in that order, and keep their names.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
from vidu4d_tpu_torch.models.gaussian.optimizer import GsAdamState
from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams, SurfelState

# a flax Head's layers -> the port's names
_RENAME = {"Dense_0": "out", "Dense_1": "hidden"}
_RENAME_BACK = {v: k for k, v in _RENAME.items()}

# the JAX package's NamedTuples in its checkpoints (`surfels.py:30-50`,
# `optimizer.py:75`) -> the port's, which have the same fields in the same
# order (the NamedTuples unpickle as ``cls.__new__(cls, *fields)``)
_STAND_INS = {
    ("vidu4d_tpu.models.gaussian.surfels", "SurfelParams"): SurfelParams,
    ("vidu4d_tpu.models.gaussian.surfels", "SurfelState"): SurfelState,
    ("vidu4d_tpu.models.gaussian.optimizer", "GsAdamState"): GsAdamState,
}
# packages whose classes are replaced by inert stand-ins (they import jax)
_FOREIGN = ("jax", "jaxlib", "flax", "optax", "vidu4d_tpu")


class JaxObject:
    """An object of a class of JAX, flax, optax or the JAX package, unpickled
    without that class: its arguments (``args``, ``kwargs``) and pickled
    state (``state``) are kept and nothing else is done with them."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"JaxObject({self.__module__}.{type(self).__name__}, {len(self.args)} args)"


class _JaxFreeUnpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._classes = {}

    def find_class(self, module, name):
        if (module, name) in _STAND_INS:
            return _STAND_INS[module, name]
        if module.split(".")[0] in _FOREIGN:
            key = (module, name)
            if key not in self._classes:
                self._classes[key] = type(name, (JaxObject,), {"__module__": module})
            return self._classes[key]
        return super().find_class(module, name)


def load_jax_checkpoint(path: str) -> Dict:
    """Read a checkpoint of either package without importing JAX or the JAX
    package: SurfelParams / SurfelState / GsAdamState become the port's
    NamedTuples (of numpy arrays), any other class of jax, jaxlib, flax,
    optax or vidu4d_tpu (the Stage-2 ``FieldState``, optax states) a
    `JaxObject`. The port's own checkpoints hold dicts of numpy arrays and
    read the same way. Only read files this program or the JAX package
    wrote: unpickling runs the constructors the file names."""
    with open(path, "rb") as f:
        return _JaxFreeUnpickler(f).load()


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def flax_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """Flatten a flax ``{"params": {...}}`` tree into a torch state dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            head = set(node) == set(_RENAME)
            for k, v in node.items():
                walk(v, path + [_RENAME[k] if head else k])
            return
        arr = np.asarray(node, dtype=np.float32)
        if path[-1] == "kernel":
            path = path[:-1] + ["weight"]
            arr = arr.T
        out[".".join(path)] = torch.tensor(arr)

    walk(params.get("params", params), [])
    return out


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Dict:
    """A torch state dict -> a flax ``{"params": {...}}`` tree of numpy
    arrays: the inverse of `flax_to_state_dict` (weights transposed back to
    kernels, ``out`` / ``hidden`` named ``Dense_0`` / ``Dense_1``)."""
    root: Dict = {}
    for key, value in sd.items():
        path = [_RENAME_BACK.get(p, p) for p in key.split(".")]
        arr = value.detach().cpu().numpy().copy()
        if path[-1] == "weight":
            path[-1], arr = "kernel", arr.T.copy()
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return {"params": root}


def load_flax_params_(module: nn.Module, params: Dict) -> None:
    """Copy a flax parameter tree into ``module`` (strict: every parameter
    must be matched, and shapes must agree)."""
    sd = flax_to_state_dict(params)
    dev = next(module.parameters()).device
    module.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)


def flax_conv_net_state_dict(module: nn.Module,
                             flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The parameters of a flax conv net, flattened with "/" as the shipped
    ``vidu4d_tpu/weights/*.npz`` hold them (RAFT's keys have no "params/"
    prefix, DepthNet's and FeatNet's have), as ``module``'s state dict.

    Each flax name (compact names such as ``Conv_0``, ``GroupNorm_1``,
    ``ResBlock_2``) is renamed by the ``FLAX_NAMES`` of the module it lies
    in (a dotted target such as ``blocks.3`` indexes a ModuleList); conv
    kernels HWIO become OIHW weights, GroupNorm scales weights."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        mod, names = module, []
        for p in parts[:-1]:
            name = getattr(type(mod), "FLAX_NAMES", {}).get(p, p)
            mod = mod.get_submodule(name)
            names.append(name)
        leaf, arr = parts[-1], np.array(arr, dtype=np.float32)
        if leaf == "kernel":
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1).copy()
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(names + [leaf])] = torch.tensor(arr)
    return out


def flax_conv_net_flat(module: nn.Module, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse of `flax_conv_net_state_dict`: ``module``'s parameters as
    the flat flax dict of the shipped ``.npz`` files, keys joined with "/"
    after ``prefix`` ("params/" for DepthNet and FeatNet, "" for RAFT), in
    sorted order; OIHW weights become HWIO kernels, GroupNorm weights
    scales. Every value is a float32 numpy copy."""
    out = {}

    def walk(mod: nn.Module, path: list) -> None:
        back = {v: k for k, v in getattr(type(mod), "FLAX_NAMES", {}).items()}
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                for i, sub in enumerate(child):
                    walk(sub, path + [back.get(f"{name}.{i}", f"{name}.{i}")])
            else:
                walk(child, path + [back.get(name, name)])
        for leaf, p in mod.named_parameters(recurse=False):
            arr = p.detach().cpu().numpy().astype(np.float32, copy=True)
            if isinstance(mod, nn.Conv2d) and leaf == "weight":
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0).copy()
            elif isinstance(mod, nn.GroupNorm) and leaf == "weight":
                leaf = "scale"
            out[prefix + "/".join(path + [leaf])] = arr

    walk(module, [])
    return dict(sorted(out.items()))


def load_flax_conv_net_(module: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Copy a flattened flax conv net (`flax_conv_net_state_dict`) into
    ``module`` (strict: every parameter matched, shapes equal)."""
    sd = flax_conv_net_state_dict(module, flat)
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


def _adam_state(opt_state: Any):
    """(count, mu, nu) of the one Adam state in an optax chain's state: live
    optax NamedTuples, or `JaxObject` stand-ins from a checkpoint (whose
    ``args`` are the NamedTuple's fields)."""
    found = []
    for s in opt_state:
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append((s.count, s.mu, s.nu))
        elif isinstance(s, JaxObject) and type(s).__name__ == "ScaleByAdamState":
            found.append(tuple(s.args))
    if len(found) != 1:
        raise ValueError("expected one Adam state in the optax chain")
    return found[0]


def warp_adamw_from_optax(opt_state: Any, module: nn.Module, device) -> Dict:
    """An optax state of `make_stage2_optimizer`'s chain (numpy leaves; the
    Stage-3 ``warp_opt_state`` or a Stage-2 ``opt_state``) -> the state of
    the port's ``WarpAdamW`` over ``module``'s named parameters: {"count",
    "mu", "nu"} (``WarpAdamW.load_state`` takes it). Moments are renamed
    and transposed as `flax_to_state_dict` does the parameters (with the
    Stage-2 field names of `dvr_state_dict_from_flax`)."""
    count, mu, nu = _adam_state(opt_state)
    names = {k for k, _ in module.named_parameters()}
    out = {"count": int(np.asarray(count))}
    for key, tree in (("mu", mu), ("nu", nu)):
        sd = dvr_state_dict_from_flax(tree)
        if set(sd) != names:
            raise ValueError(f"{key} does not match the module's parameters: "
                             f"{sorted(set(sd) ^ names)}")
        out[key] = {k: v.to(device) for k, v in sd.items()}
    return out


def dvr_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """`flax_to_state_dict` with the Stage-2 model's field subtrees
    ``fields_<cate>`` named ``fields.<cate>`` (a tree without them passes
    unchanged)."""
    out = {}
    for k, v in flax_to_state_dict(params).items():
        head, _, rest = k.partition(".")
        if head.startswith("fields_"):
            k = f"fields.{head[len('fields_'):]}.{rest}"
        out[k] = v
    return out


def dvr_flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of `dvr_state_dict_from_flax`: the Stage-2 model's state
    dict -> its flax tree ``{"params": {"fields_fg": ..., "intrinsics":
    ...}}`` of numpy arrays."""
    renamed = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "fields":
            k = ".".join([f"fields_{parts[1]}"] + parts[2:])
        renamed[k] = v
    return state_dict_to_flax(renamed)


def field_states_from_checkpoint(states: Dict, device) -> Dict[str, FieldState]:
    """A checkpoint's per-category field states (JAX: FieldState, a
    `JaxObject` whose ``args`` are its fields; the port: dicts of the
    FieldState fields) -> FieldState tensors on ``device``."""
    out = {}
    for cate, st in states.items():
        vals = st.args if isinstance(st, JaxObject) else [st[f] for f in FieldState._fields]
        out[cate] = FieldState(*[torch.tensor(np.asarray(v, np.float32), device=device)
                                 for v in vals])
    return out
