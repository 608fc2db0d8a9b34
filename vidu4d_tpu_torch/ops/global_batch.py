"""Reductions over the training batch when data-parallel ranks each hold a
share of it.

A data-parallel step (`parallel.sharding`) runs its loss inside
``over(share)``, where ``share`` is this rank's `sharding.Share`: its
``weight`` (1, or 1 / world where every rank holds every row), whether
it is the ``root`` rank and ``holds_first`` pair, and its ``mesh``
(``rank``, ``world``, ``all_reduce_``). Inside it each reduction below is
this rank's part of the global batch's value: a local sum over the
global count, so that the ranks' parts sum to the one-process value. Outside it (one process, eval renders) each is the
plain reduction. The losses and the render read these functions and
nothing of the ranks; only the trainer decides the split.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch

_SHARE = None


@contextlib.contextmanager
def over(share):
    """Reductions inside the block are over the global batch of which this
    rank holds ``share`` (None: this process holds all of it)."""
    global _SHARE
    prev, _SHARE = _SHARE, share
    try:
        yield
    finally:
        _SHARE = prev


def _split():
    """The current share when the batch is split over several ranks."""
    return _SHARE if _SHARE is not None and _SHARE.mesh.world > 1 else None


def total(x: torch.Tensor) -> torch.Tensor:
    """The global batch's sum of ``x`` (this rank's sum), detached, on
    every rank."""
    s = _split()
    if s is None:
        return x.detach()
    return s.mesh.all_reduce_(x.detach() * s.weight)


def weighted(x: torch.Tensor) -> torch.Tensor:
    """This rank's sum ``x`` as its part of the global sum (x itself unless
    every rank holds every row)."""
    s = _split()
    return x if s is None else x * s.weight


def numel(v: torch.Tensor) -> float:
    """The element count of the global batch's ``v`` (no collective: the
    shares are known)."""
    s = _split()
    if s is None:
        return float(v.numel())
    return float(round(v.numel() * s.mesh.world * s.weight))


def mean(v: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``torch.mean`` over the global batch."""
    if _split() is None:
        return torch.mean(v)
    return weighted(torch.sum(v)) / numel(v)


def mean_detached(v: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of ``v`` on every rank, detached."""
    if _split() is None:
        return torch.mean(v.detach())
    return total(torch.sum(v)) / numel(v)


def amax(x: torch.Tensor) -> torch.Tensor:
    """The global batch's max of this rank's (0-d, detached) max ``x``."""
    s = _split()
    return x if s is None else s.mesh.all_reduce_(x.detach().clone(), "max")


def once(x: torch.Tensor) -> torch.Tensor:
    """A term that does not depend on the batch: ``x`` on rank 0, zeros on
    the others, so that it counts once."""
    s = _split()
    return x if s is None or s.root else torch.zeros_like(x.detach())


def first_pair(x: torch.Tensor) -> torch.Tensor:
    """A term of the global batch's first pair: ``x`` on the rank holding
    it, zeros on the others."""
    s = _split()
    if s is None:
        return x
    return x * s.weight if s.holds_first else torch.zeros_like(x.detach())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the cotangents over the ranks
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def strided_rows(xs: Sequence[torch.Tensor], k: int) -> List[torch.Tensor]:
    """Rows ``0, s, 2 s, ...`` (k of them, s = total // k) of the global
    batch's (total, C_i) arrays ``xs``, differentiable. Split over ranks,
    each contributes the rows it holds and every rank gets all k (one
    all-reduce, whose backward sums the cotangents); a rank that holds
    every row takes them itself."""
    s = _split()
    n = xs[0].shape[0]
    if s is None or s.weight != 1.0:
        k = min(k, n)
        stride = max(1, n // k)
        return [x[::stride][:k] for x in xs]
    count = n * s.mesh.world
    k = min(k, count)
    idx = torch.arange(k, device=xs[0].device) * max(1, count // k)
    lo = s.mesh.rank * n
    own = torch.nonzero((idx >= lo) & (idx < lo + n)).flatten()
    rows = torch.cat([x[idx[own] - lo] for x in xs], dim=-1)
    buf = torch.zeros((k, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    buf = _AllReduceSum.apply(buf.index_copy(0, own, rows), s.mesh)
    return list(torch.split(buf, [x.shape[-1] for x in xs], dim=-1))
