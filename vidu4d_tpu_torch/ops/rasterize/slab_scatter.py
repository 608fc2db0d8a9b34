"""Entry -> surfel reduction of the property slab's gradient: the backward of
`tile_forward.pack_props`' row gather.

``out[p, :n_used]`` is the sum of ``g[r, :n_used]`` over the live rows
``r`` of the slab with ``ids[r] == p``, in ascending row order, and every
other element of the ``(P, 32)`` output is 0. The live rows are each tile's
``[tile_start, tile_start + tile_count)``: the tile kernels read and write no
other row, so the binning's pads and sentinel emissions (all id 0) carry no
gradient and are not visited. `slab_scatter` runs the hand-written kernel of
``csrc/slab_scatter.cu`` for float32 tensors on a CUDA device (a segment
sum over the surfel-sorted rows, no float atomics: the same bits on every
run, and those of the plain version) and its plain PyTorch version
`slab_scatter_plain` (``index_add_`` over the live rows in row order) for
tensors on the CPU. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from vidu4d_tpu_torch import kernels

WIDTH = 32  # slab and output row width (tile_forward.SLAB_WIDTH; kSSWidth)


def all_rows(n_rows: int, device):
    """The tile table that makes every one of ``n_rows`` rows live."""
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.full((1,), n_rows, dtype=torch.int32, device=device))


def live_rows(tile_start: torch.Tensor, tile_count: torch.Tensor) -> torch.Tensor:
    """(L,) int64: the rows of every tile's segment, in ascending order."""
    count = torch.clamp(tile_count.long(), min=0)
    first = tile_start.long() - (torch.cumsum(count, 0) - count)
    rows = torch.repeat_interleave(first, count) + torch.arange(
        int(count.sum()), device=count.device)
    return torch.sort(rows).values


def slab_scatter_plain(g: torch.Tensor, ids: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, n_props: int, n_used: int) -> torch.Tensor:
    """Plain PyTorch version of `slab_scatter` (any float dtype)."""
    kernels.COUNTS["slab_scatter_plain"] += 1
    rows = live_rows(tile_start, tile_count)
    narrow = torch.zeros((n_props, n_used), dtype=g.dtype, device=g.device)
    narrow.index_add_(0, ids[rows], g[rows, :n_used])
    rest = torch.zeros((n_props, g.shape[1] - n_used), dtype=g.dtype, device=g.device)
    return torch.cat([narrow, rest], dim=1)


def slab_scatter(g: torch.Tensor, ids: torch.Tensor, tile_start: torch.Tensor,
                 tile_count: torch.Tensor, n_props: int, n_used: int) -> torch.Tensor:
    """(P, 32) gradient of the surfel properties from the (E, 32) slab
    gradient ``g`` and the slab's (E,) int64 surfel ids, over the live rows
    of the (T,) int32 tile table (`all_rows`: every row is live); only the
    first ``n_used`` columns are read. The tiles' segments are disjoint, as
    the binning makes them. CPU tensors run the plain version; float32
    CUDA tensors launch the kernel, or this raises."""
    if g.dim() != 2 or g.shape[1] != WIDTH or ids.shape != g.shape[:1]:
        raise ValueError(f"g must be (E, {WIDTH}) with ids (E,), got {tuple(g.shape)} and "
                         f"{tuple(ids.shape)}")
    if not 0 <= n_used <= WIDTH:
        raise ValueError(f"n_used must be in [0, {WIDTH}], got {n_used}")
    if g.device.type == "cpu":
        return slab_scatter_plain(g, ids, tile_start, tile_count, n_props, n_used)
    if g.device.type != "cuda":
        raise ValueError(f"no slab_scatter kernel for device {g.device}")
    dev = g.device
    n_rows, n_tiles = g.shape[0], tile_start.shape[0]
    if n_rows >= 2 ** 31 or n_props >= 2 ** 31:
        raise ValueError(f"{n_rows} rows or {n_props} surfels: the kernel indexes with int32")
    g = g.contiguous()
    kernels.check_tensor("g", g, dev)
    if g.data_ptr() % 16:
        raise ValueError("g must start on a 16-byte boundary (the kernel reads float4)")
    kernels.check_tensor("ids", ids, dev, (n_rows,), torch.int64)
    kernels.check_tensor("tile_start", tile_start, dev, (n_tiles,), torch.int32)
    kernels.check_tensor("tile_count", tile_count, dev, (n_tiles,), torch.int32)
    out = torch.empty((n_props, WIDTH), dtype=torch.float32, device=dev)
    if n_props == 0:
        return out
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    cnt = torch.zeros(n_props, dtype=torch.int32, device=dev)
    rc = lib.vidu4d_slab_count(ids.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
                               cnt.data_ptr(), n_tiles, n_rows, n_props, stream)
    kernels.check_launch(rc, "slab_scatter count")
    seg_end = torch.cumsum(cnt, 0, dtype=torch.int32)
    # the tiles' segments are disjoint, so at most n_rows rows are live
    seg = torch.empty(max(n_rows, 1), dtype=torch.int32, device=dev)
    rc = lib.vidu4d_slab_place_sum(
        g.data_ptr(), ids.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        cnt.data_ptr(), seg_end.data_ptr(), seg.data_ptr(), out.data_ptr(), n_tiles, n_rows,
        n_props, n_used, stream)
    kernels.check_launch(rc, "slab_scatter")
    kernels.COUNTS["slab_scatter"] += 1
    return out
