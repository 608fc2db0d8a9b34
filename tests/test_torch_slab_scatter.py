"""The entry -> surfel reduction of the slab's gradient
(`ops/rasterize/slab_scatter.py`, csrc/slab_scatter.cu): the backward of
`tile_forward.pack_props`' row gather.

On the CPU: the plain version against a dense ``index_add_`` over the live
rows only, found tile by tile here, bit for bit, on a binning-like slab
whose pads, sentinel rows and unused columns carry non-zero junk (empty
tiles, surfels with no row, surfel 0 with live rows, n_extra 0 / 3 / 11,
an entry cap cutting a tile); the table that makes every row live; the
wrapper's refusals; a float64
``gradcheck`` of `pack_props`' backward through the tile table, on the rows
the table makes live.

On a card (marker ``cuda``; the file imports nothing of JAX, so
``python3 -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_slab_scatter.py``): the kernel against the plain version on
a CPU copy, bit for bit, and the same bits on a second call, on the same
slabs; one surfel holding 100,000 live rows (the block-wide sort); a
static-like shape (4M rows, 1M surfels, 17% of the rows live).
"""

import numpy as np
import pytest
import torch

from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.ops.rasterize import common
from vidu4d_tpu_torch.ops.rasterize import slab_scatter as ss
from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

EXTRAS = (0, 3, 11)


def slab(seed, n_tiles=40, n_props=300, chunk=8, cap=False, max_count=30, n_extra=3):
    """A slab laid out as the binning lays it: each tile's live rows from a
    multiple of ``chunk``, id-0 pads up to the next one, a tail of id-0
    sentinel rows; with ``cap``, an entry cap that falls in the middle of
    the live rows of the tile two thirds in (the first rows kept, the tables
    cut as `bin_splats_aligned` cuts them). Every row and column of g holds
    junk. Returns (g, ids, tile_start, tile_count, n_props, n_used)."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, max_count, n_tiles)
    count[[1, n_tiles // 2]] = 0
    padded = -(-count // chunk) * chunk
    start = np.cumsum(padded) - padded
    n_rows = int(padded.sum()) + 13
    ids = np.zeros(n_rows, np.int64)
    for s, c in zip(start, count):
        # surfels [n_props - 20, n_props) get no row; surfel 0 gets some
        ids[s:s + c] = rng.integers(0, n_props - 20, c)
    g = rng.normal(size=(n_rows, tf.SLAB_WIDTH)).astype(np.float32)
    if cap:
        k = next(k for k in range(2 * n_tiles // 3, n_tiles) if count[k] >= 4)
        cap = int(start[k] + count[k] // 2)
        cut = np.minimum(start, cap)
        count = np.minimum(start + count, cap) - cut
        start, ids, g = cut, ids[:cap], g[:cap]
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    return (torch.from_numpy(g), torch.from_numpy(ids), i32(start), i32(count), n_props,
            tf.EXTRA + n_extra)


def dense(g, ids, tile_start, tile_count, n_props, n_used):
    """index_add_ over the live rows in ascending order, found tile by tile."""
    live = sorted(r for s, c in zip(tile_start.tolist(), tile_count.tolist())
                  for r in range(s, s + c))
    live = torch.as_tensor(live, dtype=torch.int64)
    src = g[live].clone()
    src[:, n_used:] = 0.0
    return torch.zeros((n_props, g.shape[1]), dtype=g.dtype).index_add_(0, ids[live], src)


CASES = {f"n_extra {x}": dict(n_extra=x) for x in EXTRAS}
CASES["entry cap"] = dict(cap=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_dense_index_add_over_live_rows(case):
    args = slab(5, **CASES[case])
    before = dict(kernels.COUNTS)
    got = ss.slab_scatter(*args)
    assert kernels.COUNTS["slab_scatter_plain"] == before["slab_scatter_plain"] + 1
    assert kernels.COUNTS["slab_scatter"] == before["slab_scatter"]
    g, ids, start, count, n_props, n_used = args
    assert got.shape == (n_props, tf.SLAB_WIDTH)
    assert torch.equal(got, dense(*args))
    assert not got[:, n_used:].any() and not got[n_props - 20:].any()
    # surfel 0 has live rows beside the id-0 pads and sentinels, whose junk
    # the dense sum leaves out
    is_live = torch.zeros(g.shape[0], dtype=torch.bool)
    is_live[ss.live_rows(start, count)] = True
    assert (ids[is_live] == 0).any() and (ids[~is_live] == 0).all()
    assert g[~is_live].abs().min() > 0 and got[0].abs().sum() > 0
    if case == "entry cap":
        full = slab(5)[3]
        assert ((count > 0) & (count < full)).any() and count.sum() < full.sum()


def test_all_rows_table_makes_every_row_live():
    g, ids, _, _, n_props, n_used = slab(6)
    start, count = ss.all_rows(g.shape[0], g.device)
    src = g.clone()
    src[:, n_used:] = 0.0
    want = torch.zeros((n_props, g.shape[1])).index_add_(0, ids, src)
    assert torch.equal(ss.slab_scatter(g, ids, start, count, n_props, n_used), want)


def test_wrapper_refuses_what_it_cannot_take():
    g, ids, start, count, n_props, n_used = slab(7)
    with pytest.raises(ValueError, match="must be"):
        ss.slab_scatter(g[:, :30], ids, start, count, n_props, n_used)
    with pytest.raises(ValueError, match="n_used"):
        ss.slab_scatter(g, ids, start, count, n_props, 33)
    with pytest.raises(ValueError, match="no slab_scatter kernel"):
        ss.slab_scatter(g.to("meta"), ids.to("meta"), start.to("meta"), count.to("meta"),
                        n_props, n_used)


def test_pack_props_gradcheck_through_the_tile_table():
    """float64 ``gradcheck`` of `pack_props` on the rows the frame's binning
    makes live (its chunk pads and sentinel rows are outside): the gradient
    of every surfel input through the table."""
    rng = np.random.default_rng(11)
    p, res = 24, 32
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    means = f64(np.c_[rng.uniform(-1.0, 1.0, (p, 2)), rng.uniform(2.5, 4.0, p)])
    quats = f64(rng.normal(size=(p, 4)))
    quats = quats / quats.norm(dim=-1, keepdim=True)
    scales = f64(rng.uniform(0.05, 0.3, (p, 2)))
    intr = f64([[res, res, res / 2, res / 2]])
    proj = common.project_splats(means[None], quats[None], scales,
                                 torch.eye(4, dtype=torch.float64), intr)
    frame = common.SplatProjection(*[x[0] for x in proj])
    binning = common.bin_splats_aligned(frame, res, res, tile=16, entry_cap=40)
    live = ss.live_rows(binning.tile_start, binning.tile_count)
    assert 0 < live.numel() < binning.sorted_splat_ids.numel()
    colors, opac = f64(rng.uniform(size=(p, 3 + 2))), f64(rng.uniform(0.1, 0.9, p))

    def packed(tu, tv, tw, center2d, normal, colors, opac):
        f = frame._replace(tu=tu, tv=tv, tw=tw, center2d=center2d, normal=normal)
        return tf.pack_props(f, colors, opac, binning.sorted_splat_ids, binning.tile_start,
                             binning.tile_count)[live]

    inputs = [x.detach().clone().requires_grad_(True)
              for x in (frame.tu, frame.tv, frame.tw, frame.center2d, frame.normal, colors,
                        opac)]
    assert torch.autograd.gradcheck(packed, inputs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def on(args, dev):
    return tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)


def kernel_vs_plain(args, card):
    """The kernel twice on the card and the plain version on the CPU:
    asserts equal bits and one launch each, no plain call."""
    before = dict(kernels.COUNTS)
    got = ss.slab_scatter(*on(args, card))
    again = ss.slab_scatter(*on(args, card))
    torch.cuda.synchronize()
    assert kernels.COUNTS["slab_scatter"] == before["slab_scatter"] + 2
    assert kernels.COUNTS["slab_scatter_plain"] == before["slab_scatter_plain"]
    want = ss.slab_scatter(*on(args, "cpu"))
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_bit_for_bit(case, card):
    args = slab(5, **CASES[case])
    kernel_vs_plain(args, card)
    g, ids, _, _, n_props, n_used = args
    kernel_vs_plain((g, ids, *ss.all_rows(g.shape[0], g.device), n_props, n_used), card)


@pytest.mark.cuda
def test_cuda_one_surfel_with_100k_rows(card):
    """A segment far past the rank sort's 32 rows: the block sorts it in
    place; the other surfels of its block keep the short path."""
    g, ids, start, count, n_props, n_used = slab(9, n_tiles=2000, max_count=120)
    live = ss.live_rows(start, count)
    assert live.numel() > 100_000
    ids[live[:100_000]] = 7
    got = kernel_vs_plain((g, ids, start, count, n_props, n_used), card)
    assert got[7].abs().sum() > 0


@pytest.mark.cuda
def test_cuda_static_like_shape(card):
    """4M slab rows over 4,056 tiles, 1M surfels, 17% of the rows live, ids
    drawn at random (a few rows each), junk in every other row."""
    rng = np.random.default_rng(12)
    n_tiles, n_props, chunk = 4056, 1_000_000, 128
    count = rng.integers(0, 340, n_tiles)
    padded = -(-count // chunk) * chunk
    start = np.cumsum(padded) - padded
    n_rows = 4_000_000
    assert padded.sum() < n_rows
    ids = np.zeros(n_rows, np.int64)
    for s, c in zip(start, count):
        ids[s:s + c] = rng.integers(0, n_props, c)
    g = torch.randn((n_rows, tf.SLAB_WIDTH), generator=torch.Generator().manual_seed(12))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    assert 0.15 < count.sum() / n_rows < 0.19
    kernel_vs_plain((g, torch.from_numpy(ids), i32(start), i32(count), n_props, tf.EXTRA + 2),
                    card)
