"""Densification / pruning / opacity reset on the fixed-capacity store
(`vidu4d_tpu/models/gaussian/densify.py`).

  clone  - grad >= thr and max(scale) <= percent_dense * extent: copy
  split  - grad >= thr and max(scale) >  percent_dense * extent: 2 children
           drawn from N(0, diag(s)) in the splat frame, scales / (0.8 N),
           the original dies
  prune  - opacity < min_opacity, plus (when max_screen_size > 0) screen
           radius > max_screen_size or world scale > 0.1 extent

Children go into dead slots, in the order of a stable argsort of the
surviving mask (dead slots first); children beyond the dead slots are
dropped and counted. Their Adam moment rows are zeroed and every
densification statistic resets.

The store's parameter leaves and the Adam moments are written in place
(under ``torch.no_grad``), so the step's optimiser keeps its tensors; the
mask and the statistics are new tensors in the returned state. Nothing here
waits for the device: the ``info`` counts are 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from vidu4d_tpu_torch.models.gaussian.optimizer import GsAdamState
from vidu4d_tpu_torch.models.gaussian.surfels import (
    SurfelState,
    get_opacity,
    get_rotation,
    get_scaling,
    inverse_sigmoid,
)
from vidu4d_tpu_torch.ops.quaternion import quaternion_to_matrix

# (query, candidate) pairs per chunk of `radius_outlier_mask`: each float32
# (chunk, N) intermediate is 256 MiB
OUTLIER_CHUNK_PAIRS = 1 << 26


class DensifyConfig(NamedTuple):
    grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    split_n: int = 2  # children per split parent (the clone uses child 0)
    scale_shrink: float = 0.8  # children's scale divisor = scale_shrink * split_n


@torch.no_grad()
def densify_and_prune(
    state: SurfelState,
    adam: GsAdamState,
    noise: torch.Tensor,
    extent: float,
    max_screen_size: float = 0.0,
    config: DensifyConfig = DensifyConfig(),
) -> Tuple[SurfelState, GsAdamState, Dict[str, torch.Tensor]]:
    """One densify + prune pass (`densify.py:68`). ``noise`` (N, split_n, 2):
    standard normal draws of the split children's offsets in the splat
    frame. Writes ``state.params`` and ``adam``'s moments in place; returns
    (state, adam, info) with info counts "cloned", "split", "pruned",
    "dropped_children", "alive"."""
    p = state.params
    cap = state.capacity
    alive = state.alive

    grads = state.grad_accum / torch.clamp(state.denom, min=1e-12)
    grads = torch.where(torch.isnan(grads) | (state.denom == 0), 0.0, grads)
    scaling = get_scaling(p)  # (N, 2)
    max_scale = torch.amax(scaling, dim=-1)
    opacity = get_opacity(p)[:, 0]

    hot = alive & (grads >= config.grad_threshold)
    small = max_scale <= config.percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    prune = opacity < config.min_opacity
    if max_screen_size > 0:
        prune = prune | (state.max_radii2d > max_screen_size) | (max_scale > 0.1 * extent)
    alive_after = alive & ~split_mask & ~prune

    # split children: x + R @ (n0 s0, n1 s1, 0), as multiply-adds in full
    # float32 (the third column of R meets a zero)
    n_child = config.split_n
    rot = quaternion_to_matrix(get_rotation(p))  # (N, 3, 3)
    offs = noise * scaling[:, None, :]  # (N, C, 2)
    split_xyz = p.xyz[:, None, :] + (rot[:, None, :, 0] * offs[..., 0:1]
                                     + rot[:, None, :, 1] * offs[..., 1:2])  # (N, C, 3)
    split_scaling = torch.log(scaling / (config.scale_shrink * n_child))

    # children have no screen radius: only the opacity and world-size rules
    child_prune = opacity < config.min_opacity
    if max_screen_size > 0:
        child_prune_split = child_prune | (
            torch.amax(torch.exp(split_scaling), dim=-1) > 0.1 * extent)
        child_prune_clone = child_prune | (max_scale > 0.1 * extent)
    else:
        child_prune_split = child_prune_clone = child_prune
    valid_split = split_mask & ~child_prune_split
    # child c of parent i is entry c * N + i (c = 0: the clone or split child 0)
    valid_flat = torch.cat([(clone_mask & ~child_prune_clone) | valid_split]
                           + [valid_split] * (n_child - 1))

    # the k-th valid child (by rank) goes to the k-th slot of the stable
    # dead-first order, while k < the number of dead slots
    dead_order = torch.argsort(alive_after.to(torch.int8), stable=True)
    num_dead = cap - torch.sum(alive_after.to(torch.int64))
    num_valid = torch.sum(valid_flat.to(torch.int64))
    by_rank = torch.argsort((~valid_flat).to(torch.int8), stable=True)[:cap]
    k = torch.arange(cap, device=alive.device)
    write = (k < num_valid) & (k < num_dead)
    parent, child = by_rank % cap, by_rank // cap
    is_clone = (child == 0) & clone_mask[parent]

    def rows(leaf: torch.Tensor, values) -> None:
        w = write.reshape((cap,) + (1,) * (leaf.dim() - 1))
        leaf[dead_order] = torch.where(w, values, leaf[dead_order])

    new_values = {f: getattr(p, f)[parent] for f in p._fields}
    new_values["xyz"] = torch.where(is_clone[:, None], p.xyz[parent],
                                    split_xyz[parent, child])
    new_values["scaling"] = torch.where(is_clone[:, None], p.scaling[parent],
                                        split_scaling[parent])
    for f in p._fields:
        rows(getattr(p, f), new_values[f])
        rows(getattr(adam.mu, f), 0.0)
        rows(getattr(adam.nu, f), 0.0)
    new_alive = alive_after.clone()
    new_alive[dead_order] = alive_after[dead_order] | write

    zeros = torch.zeros_like(state.grad_accum)
    new_state = SurfelState(params=p, alive=new_alive, max_radii2d=zeros,
                            grad_accum=zeros.clone(), denom=zeros.clone())
    written = torch.minimum(num_valid, num_dead)
    info = {
        "cloned": torch.sum(clone_mask.to(torch.int64)),
        "split": torch.sum(split_mask.to(torch.int64)),
        "pruned": torch.sum((alive & prune).to(torch.int64)),
        "dropped_children": num_valid - written,
        "alive": torch.sum(new_alive.to(torch.int64)),
    }
    return new_state, adam, info


@torch.no_grad()
def reset_opacity(state: SurfelState, adam: GsAdamState,
                  ceiling: float = 0.01) -> Tuple[SurfelState, GsAdamState]:
    """Clamp every opacity to <= ceiling and zero its Adam moments
    (`densify.py:185`), in place."""
    op = state.params.opacity
    op.copy_(inverse_sigmoid(torch.clamp(get_opacity(state.params), max=ceiling)))
    adam.mu.opacity.zero_()
    adam.nu.opacity.zero_()
    return state, adam


def prune_by_mask(state: SurfelState, prune_mask: torch.Tensor) -> SurfelState:
    """Kill the splats of ``prune_mask`` (`densify.py:197`)."""
    return state._replace(alive=state.alive & ~prune_mask)


@torch.no_grad()
def radius_outlier_mask(xyz: torch.Tensor, alive: torch.Tensor, nb_points: int = 20,
                        radius: float = 0.004) -> torch.Tensor:
    """Alive splats with fewer than ``nb_points`` other alive splats within
    ``radius`` (`densify.py:205`). Squared distances take the JAX package's
    form |q|^2 + |p|^2 - 2 q.p, with the 3-wide product as multiply-adds in
    float32 (no matmul, so no TF32), over chunks of queries."""
    n = xyz.shape[0]
    sq = torch.sum(xyz * xyz, dim=-1)
    r2 = torch.tensor(radius * radius, dtype=xyz.dtype, device=xyz.device)
    chunk = max(1, OUTLIER_CHUNK_PAIRS // max(n, 1))
    counts = torch.empty(n, dtype=torch.int64, device=xyz.device)
    for s in range(0, n, chunk):
        q = xyz[s:s + chunk]
        dot = q[:, 0:1] * xyz[:, 0]
        dot.addcmul_(q[:, 1:2], xyz[:, 1])
        dot.addcmul_(q[:, 2:3], xyz[:, 2])
        d2 = sq[s:s + chunk, None] + sq[None, :]
        d2.sub_(dot.mul_(2.0))
        counts[s:s + chunk] = torch.count_nonzero((d2 <= r2) & alive, dim=1)
    # the query itself is always within the radius
    return alive & ((counts - 1) < nb_points)
