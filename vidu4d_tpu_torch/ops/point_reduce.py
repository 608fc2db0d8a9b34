"""Contractions over the point axis into a small output:
``out[k] = a[k]^T @ b[k]`` for ``a`` (batch, n, p) and ``b`` (batch, n, q).

The warp stack's backward sums over 10^4-10^6 points into the bone
quaternions' (25 x 4) and the bones' rotations' (75 x 3) gradients.
`point_reduce` runs the hand-written kernel of ``csrc/point_reduce.cu`` for
float32 and float64 tensors on a CUDA device (a split over the points in
chunks, then a fixed-order sum of the chunks' partials: the same bits on
every run) and its plain PyTorch version `point_reduce_plain` for tensors on
the CPU. There is no fallback from one to the other. `plan` picks the
kernel's staged rows and chunks from the shape. `reduce_points` is the form
the backward passes call: differentiable where grad mode is on, so that a
backward built from it can itself be differentiated
(`DynNeRF.compute_normal` takes the gradient through the warp with
``create_graph``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from vidu4d_tpu_torch import kernels

THREADS = 256          # threads of a block (kPRThreads)
TILE = 4               # a thread's outputs: TILE x TILE (kPRTile)
STAGE_BYTES = 16384    # staged bytes of A and B a slab, one of two stages
MAX_SMEM = 48 * 1024   # dynamic shared bytes the kernel takes at most
MIN_ROWS = 256         # fewest rows a chunk takes
DTYPES = (torch.float32, torch.float64)  # the kernel's element types


class Plan(NamedTuple):
    chunks: int  # blocks along the points, a batch entry
    slab: int    # rows staged at a time
    smem: int    # dynamic shared bytes


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def check_width(p: int, q: int) -> None:
    """Raise unless one block's `THREADS` threads cover the p x q output
    in TILE x TILE tiles, as the kernel needs."""
    if _ceil(p, TILE) * _ceil(q, TILE) > THREADS:
        raise ValueError(f"a {p} x {q} output needs more than {THREADS} {TILE} x {TILE} "
                         "thread tiles: point_reduce takes narrower outputs")


def plan(batch: int, n: int, p: int, q: int, elem_bytes: int, sms: int,
         blocks_per_sm) -> Plan:
    """The kernel's plan for a (batch, n, p) x (batch, n, q) reduction of
    ``elem_bytes`` elements on a card of ``sms`` SMs, ``blocks_per_sm(smem)``
    resident blocks each. The output's thread tiles, p and q each padded to
    a multiple of TILE; the threads left over form row groups; each of the
    two stages holds about `STAGE_BYTES`, in a multiple of the groups' rows,
    and the shared bytes also hold the groups' tiles for their final sum;
    chunks enough for one wave of resident blocks over the batch, and no
    chunk under `MIN_ROWS` rows."""
    check_width(p, q)
    tp_n, tq_n = _ceil(p, TILE), _ceil(q, TILE)
    t_out = tp_n * tq_n
    groups = THREADS // t_out
    pitch = (tp_n + tq_n) * TILE
    slab = max(groups, STAGE_BYTES // elem_bytes // pitch // groups * groups)
    smem = elem_bytes * max(2 * slab * pitch, t_out * TILE * TILE if groups > 1 else 0)
    wave = sms * max(1, blocks_per_sm(smem))
    chunks = max(1, min(_ceil(wave, batch), _ceil(n, MIN_ROWS)))
    return Plan(chunks, slab, smem)


def point_reduce_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `point_reduce` (any float dtype)."""
    kernels.COUNTS["point_reduce_plain"] += 1
    return torch.bmm(a.transpose(1, 2), b)


@functools.lru_cache(maxsize=None)
def _card_plan(batch: int, n: int, p: int, q: int, elem_bytes: int, index: int) -> Plan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    occupancy = kernels.library().vidu4d_point_reduce_occupancy
    return plan(batch, n, p, q, elem_bytes, sms,
                lambda smem: occupancy(smem, int(elem_bytes == 8)))


def point_reduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[k] = a[k]^T @ b[k]``: a (batch, n, p), b (batch, n, q) ->
    (batch, p, q), summed over n, for outputs that `check_width` takes.
    CPU tensors run the plain version; CUDA tensors (float32 or float64,
    both alike, contiguous) launch the kernel, or this raises."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[:2] != b.shape[:2]:
        raise ValueError(f"a (batch, n, p) and b (batch, n, q) must share batch and n, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    batch, n, p = a.shape
    q = b.shape[2]
    check_width(p, q)
    if a.device.type == "cpu":
        return point_reduce_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no point_reduce kernel for device {a.device}")
    dev, dtype = a.device, a.dtype
    if dtype not in DTYPES:
        raise ValueError(f"a has dtype {dtype}: the point_reduce kernel takes {DTYPES}")
    kernels.check_tensor("a", a, dev, dtype=dtype)
    kernels.check_tensor("b", b, dev, dtype=dtype)
    out = torch.empty((batch, p, q), dtype=dtype, device=dev)
    if batch == 0 or p == 0 or q == 0:
        return out
    if n == 0:
        return out.zero_()
    elem = a.element_size()
    pl = _card_plan(batch, n, p, q, elem,
                    dev.index if dev.index is not None else torch.cuda.current_device())
    part = (torch.empty((pl.chunks, batch, p, q), dtype=dtype, device=dev)
            if pl.chunks > 1 else out)
    lib = kernels.library()
    launch = lib.vidu4d_point_reduce_f64 if elem == 8 else lib.vidu4d_point_reduce
    rc = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), batch, n, p, q,
                pl.chunks, pl.slab, pl.smem, kernels.stream_ptr(dev))
    kernels.check_launch(rc, "point_reduce")
    kernels.COUNTS["point_reduce"] += 1
    return out


class PointReduce(torch.autograd.Function):
    """Differentiable `point_reduce`; its backward is the two tall products
    ``b g^T`` and ``a g``, over the points."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return point_reduce(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(b, g.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a, g) if ctx.needs_input_grad[1] else None
        return ga, gb


def reduce_points(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[k]^T @ b[k]`` over the points, for inputs of any strides; an
    autograd node only where grad mode is on and an input needs one (a
    backward taken with ``create_graph``)."""
    a, b = a.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return PointReduce.apply(a, b)
    return point_reduce(a, b)
