"""Parity of the port's rasterizer (projection, binning, the tile
compositor's plain versions and its autograd wiring) with the JAX package.

Tolerances:
* projection to 1e-6 (same float32 formulas; sqrt/sums may differ by an
  ulp), tile rects and binning exactly (integer layouts compared with ==);
* composited outputs vs the JAX naive/tiles paths: atol 5e-4 / rtol 1e-3,
  the Pallas-vs-XLA bound of tests/test_pallas_kernel.py (the slab's affine
  intersection form rounds differently from the direct cross product);
* gradients: atol 1e-5 / rtol 1e-4 for the same reason
  (test_pallas_backward_matches_autodiff_interpret's bound);
* kernel vs plain version on the card: forward atol 5e-4, backward per
  grad-slab column 1e-3 * max |g_col| + 1e-6 * max |g| (summation order;
  per column so the small opacity / colour / normal / extra columns are
  held to their own scale; see chip_smoke.py).
Median depth / weight get no gradient on the kernel path (and are
discontinuous in the inputs), so they are left out of the comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, assert_close_per_column, make_scene, n, t
from vidu4d_tpu.ops.rasterize import common as jc
from vidu4d_tpu.ops.rasterize.reference import rasterize_naive_from_projection as jnaive
from vidu4d_tpu.ops.rasterize.xla_tiles import rasterize_tiles_from_projection
from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.ops.rasterize import common as tc
from vidu4d_tpu_torch.ops.rasterize import slab_scatter
from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf
from vidu4d_tpu_torch.ops.rasterize.reference import rasterize_naive_from_projection as tnaive

SMOOTH = ("color", "depth", "alpha", "normal", "distortion", "final_t")


def _proj_pair(scene, mask=None, dummy=None):
    means, quats, scales, _, _, intr = scene
    eye = np.eye(4, dtype=np.float32)
    jp = jax.vmap(lambda m, q, k, d: jc.project_splats(
        m, q, jnp.asarray(scales), jnp.asarray(eye), k, mask=mask, densify_dummy=d))(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(intr),
        None if dummy is None else jnp.asarray(dummy))
    tp = tc.project_splats(t(means), t(quats), t(scales), t(eye), t(intr),
                           mask=None if mask is None else t(mask),
                           densify_dummy=None if dummy is None else t(dummy))
    return jp, tp


def _frame(proj, f, mod):
    return mod.SplatProjection(*[x[f] for x in proj])


def test_project_splats_and_tile_rects():
    rng = np.random.default_rng(0)
    scene = make_scene(rng, n=300, frames=2)
    mask = rng.uniform(size=300) > 0.1
    dummy = rng.normal(size=(2, 300, 2)).astype(np.float32) * 0.01
    jp, tp = _proj_pair(scene, mask, dummy)
    for f in jc.SplatProjection._fields:
        assert_close(getattr(jp, f), getattr(tp, f), 1e-6, 1e-6, f)
    assert np.array_equal(n(jp.valid), n(tp.valid))
    for fr in range(2):
        jr = jc.compute_tile_rects(_frame(jp, fr, jc), 64, 64, 16, 4)
        tr = tc.compute_tile_rects(_frame(tp, fr, tc), 64, 64, 16, 4)
        for f in jc.TileRects._fields:
            assert_close(getattr(jr, f), getattr(tr, f), 0.0, 0.0, f)


@pytest.mark.parametrize("span_cap,entry_cap,spread", [
    (4, 0, 0.8), (2, 0, 0.8), (4, 0, 0.2), (4, 1000, 0.8), (4, 100000, 0.8),
])
def test_bin_splats_aligned_matches_jax(span_cap, entry_cap, spread):
    """Same entries, order, segment starts/counts and cap contract."""
    rng = np.random.default_rng(1)
    scene = make_scene(rng, n=400, spread=spread)
    scene = (scene[0], scene[1], scene[2] * 3.0) + scene[3:]  # some big splats
    jp, tp = _proj_pair(scene)
    jb = jc.bin_splats_aligned(_frame(jp, 0, jc), 64, 64, 16, span_cap, 128, entry_cap)
    tbin = tc.bin_splats_aligned(_frame(tp, 0, tc), 64, 64, 16, span_cap, 128, entry_cap)
    for f in jc.TileBinning._fields:
        assert np.array_equal(n(getattr(jb, f)), n(getattr(tbin, f))), f
    start, count = n(tbin.tile_start), n(tbin.tile_count)
    assert (start % 128 == 0).all()
    ids = n(tbin.sorted_splat_ids)
    for s0, c0 in zip(start, count):  # pads (id 0) sit past each segment
        seg_end = -(-c0 // 128) * 128
        assert (ids[s0 + c0:min(s0 + seg_end, ids.shape[0])] == 0).all()
    if entry_cap:
        cap = -(-entry_cap // 128) * 128 + 16 * 128
        assert ids.shape[0] == min(cap, 4 * 400 + max(32, 400 // 16) * 16 + 16 * 128)


def _raster_losses(out, extra):
    loss = (jnp if isinstance(out.color, jax.Array) else torch)
    val = (loss.mean(out.color[..., :3] ** 2) + 0.3 * loss.mean(out.depth)
           + 0.2 * loss.mean(out.alpha) + 0.1 * loss.mean(out.normal)
           + 0.5 * loss.mean(out.distortion))
    if extra:
        val = val + 0.7 * loss.mean(loss.abs(out.color[..., 3:]))
    return val


@pytest.mark.parametrize("n_extra", [0, 2])
def test_plain_rasterizer_matches_jax_tiles_values_and_grads(n_extra):
    """rasterize_batch (plain versions on the CPU) vs per-frame JAX tiles
    autodiff: every non-median output and the gradients to xyz, rot,
    scale, opacity, colours, bg and the densify dummy."""
    rng = np.random.default_rng(2 + n_extra)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=90, res=32, frames=2)
    colors = np.concatenate(
        [colors, rng.normal(size=colors.shape[:2] + (n_extra,)).astype(np.float32)], -1)
    bg = rng.uniform(size=3 + n_extra).astype(np.float32)
    dummy = np.zeros((2, 90, 2), np.float32)
    eye = np.eye(4, dtype=np.float32)
    H = W = 32

    def jloss(means, quats, scales, opac, colors, bg, dummy):
        def one(m, q, c, k, d):
            p = jc.project_splats(m, q, scales, jnp.asarray(eye), k, densify_dummy=d)
            return rasterize_tiles_from_projection(p, c, opac, bg, H, W, tile=16,
                                                   span_cap=4, budget=256, tile_chunk=2)
        out = jax.vmap(one)(means, quats, colors, jnp.asarray(intr), dummy)
        return _raster_losses(out, n_extra), out

    args = [means, quats, scales, opac, colors, bg, dummy]
    (jv, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(7)),
                                                has_aux=True))(*map(jnp.asarray, args))
    targs = [t(a, True) for a in args]
    m_, q_, s_, o_, c_, b_, d_ = targs
    proj = tc.project_splats(m_, q_, s_, t(eye), t(intr), densify_dummy=d_)
    out = tb.rasterize_batch(proj, c_, o_, b_, H, W, span_cap=4, entry_cap=0)
    tv = _raster_losses(out, n_extra)
    tv.backward()
    for f in SMOOTH:
        assert_close(getattr(jout, f), getattr(out, f), 5e-4, 1e-3, f)
    assert_close(jv, tv, 0.0, 3e-5, "loss")
    names = ["xyz", "rot", "scale", "opacity", "colors", "bg", "densify_dummy"]
    for name, jgr, ta in zip(names, jg, targs):
        assert_close(jgr, ta.grad, 1e-5, 1e-4, name)


def test_port_reference_matches_jax_naive():
    rng = np.random.default_rng(5)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=150, res=48)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jp, tp = _proj_pair((means, quats, scales, opac, colors, intr))
    jo = jnaive(_frame(jp, 0, jc), jnp.asarray(colors[0]), jnp.asarray(opac),
                jnp.asarray(bg), 48, 48)
    to = tnaive(_frame(tp, 0, tc), t(colors[0]), t(opac), t(bg), 48, 48)
    for f in jo._fields:
        assert_close(getattr(jo, f), getattr(to, f), 2e-5, 1e-4, f)


def test_plain_forward_matches_naive_oracle():
    """The plain tile compositor vs the port's own naive oracle (global
    depth order, direct cross product) on one 64x64 frame."""
    rng = np.random.default_rng(6)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=250, res=64)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    _, tp = _proj_pair((means, quats, scales, opac, colors, intr))
    ref = tnaive(_frame(tp, 0, tc), t(colors[0]), t(opac), t(bg), 64, 64)
    out = tb.rasterize_batch(tp, t(colors), t(opac), t(bg), 64, 64, entry_cap=0)
    for f in SMOOTH:
        assert_close(getattr(ref, f), getattr(out, f)[0], 5e-4, 1e-3, f)


def test_entry_cap_exact_when_under_and_truncates_when_over():
    rng = np.random.default_rng(7)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=400, res=32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    _, tp = _proj_pair((means, quats, scales, opac, colors, intr))
    entries = int(tc.bin_splats_aligned(_frame(tp, 0, tc), 32, 32).num_entries)

    def run(cap):
        o = t(opac, True)
        out = tb.rasterize_batch(tp, t(colors), o, t(bg), 32, 32, entry_cap=cap)
        (out.color ** 2).mean().backward()
        return out, o.grad

    full, g_full = run(0)
    under, g_under = run(entries + 128)
    for f in SMOOTH:
        assert torch.equal(getattr(full, f), getattr(under, f)), f
    assert torch.equal(g_full, g_under)
    over, _ = run(entries // 4)
    assert not torch.equal(full.color, over.color)


@pytest.mark.parametrize("table", ["all rows", "tiles"])
def test_row_gather_backward_is_narrow(table):
    """The backward sums the first n_used columns of the live rows: every
    row under `slab_scatter.all_rows`, the tiles' segments under a binning's
    table (rows 5-15, 28-31 and 40-47 are pads, outside them)."""
    rng = np.random.default_rng(8)
    props = t(rng.normal(size=(10, tf.SLAB_WIDTH)), True)
    ids = torch.as_tensor(rng.integers(0, 10, size=48))
    g = t(rng.normal(size=(48, tf.SLAB_WIDTH)))
    tiles = table == "tiles"
    start, count = (torch.tensor([0, 16, 32], dtype=torch.int32),
                    torch.tensor([5, 12, 8], dtype=torch.int32)) if tiles \
        else slab_scatter.all_rows(48, "cpu")
    tf._RowGather.apply(props, ids, 23, start, count).backward(g)
    live = torch.cat([torch.arange(0, 5), torch.arange(16, 28), torch.arange(32, 40)]) \
        if tiles else torch.arange(48)
    # the narrow path: index_add_ of the live rows' first 23 columns
    narrow = torch.zeros(10, 23).index_add_(0, ids[live], g[live, :23])
    assert_close(narrow, props.grad[:, :23], 1e-6)
    assert torch.equal(props.grad[:, 23:], torch.zeros(10, tf.SLAB_WIDTH - 23))


def test_wrappers_dispatch_by_device_without_fallback():
    """CPU tensors run the plain versions (and count them); a device that
    has no kernel raises instead of falling back."""
    rng = np.random.default_rng(9)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=60, res=32)
    _, tp = _proj_pair((means, quats, scales, opac, colors, intr))
    b = tb.prepare_batch(tp, t(colors), t(opac), t(np.zeros(3)), 32, 32)
    geo = (b["tiles_x"], b["tiles_per_frame"], b["n_extra"])
    before = dict(kernels.COUNTS)
    col, aux = tf.forward_tiles(b["slab"], b["tile_start"], b["tile_count"], b["bg"], *geo)
    assert kernels.COUNTS["tile_forward_plain"] == before["tile_forward_plain"] + 1
    assert kernels.COUNTS["tile_forward"] == before["tile_forward"]
    assert col.shape == (4, 256, 3) and aux.shape == (4, 256, 12)
    meta = [x.to("meta") for x in (b["slab"], b["tile_start"], b["tile_count"], b["bg"])]
    with pytest.raises(ValueError):
        tf.forward_tiles(*meta, *geo)


@pytest.mark.cuda
@pytest.mark.parametrize("n_extra", [0, 2])
def test_cuda_kernels_match_plain_versions(n_extra):
    """Each CUDA kernel vs its plain version on the card (needs nvcc + a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(10)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=3000, res=64, frames=2)
    colors = np.concatenate(
        [colors, rng.normal(size=colors.shape[:2] + (n_extra,)).astype(np.float32)], -1)
    dev = "cuda"
    proj = tc.project_splats(t(means, device=dev), t(quats, device=dev),
                             t(scales, device=dev), torch.eye(4, device=dev),
                             t(intr, device=dev))
    bg = t(rng.uniform(size=3 + n_extra), device=dev)
    b = tb.prepare_batch(proj, t(colors, device=dev), t(opac, device=dev), bg, 64, 64)
    geo = (b["tiles_x"], b["tiles_per_frame"], b["n_extra"])
    fw = (b["slab"], b["tile_start"], b["tile_count"], b["bg"])
    col_k, aux_k = tf.forward_tiles(*fw, *geo)
    col_p, aux_p = tf.forward_tiles_plain(*fw, *geo)
    smooth = [i for i in range(12) if i not in (5, 7, 9)]
    assert_close(col_p, col_k, 5e-4)
    assert_close(aux_p[..., smooth], aux_k[..., smooth], 5e-4)
    cot = torch.randn((b["tile_start"].shape[0], 256, 10 + n_extra), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    bw = (b["slab"], b["tile_start"], b["tile_count"], cot, aux_k[..., 8:12].contiguous())
    assert_close_per_column(tb.backward_tiles_plain(*bw, *geo),
                            tb.backward_tiles(*bw, *geo), 1e-3, 1e-6, "grad slab")


@pytest.mark.slow
def test_plain_rasterizer_matches_pallas_interpret_batch():
    """vs the JAX kernel path itself (Pallas interpreter): same slab and
    algorithm; XLA may contract the slab's cancellation-prone affine terms
    into FMAs, so the bounds are the module's (5e-4 / 1e-5)."""
    from vidu4d_tpu.ops.rasterize.pallas_backward import rasterize_pallas_grad_batch

    rng = np.random.default_rng(11)
    means, quats, scales, opac, colors, intr = make_scene(rng, n=70, res=32, frames=2)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    eye = np.eye(4, dtype=np.float32)

    def jloss(means, opac, colors):
        p = jax.vmap(lambda m, q, k: jc.project_splats(
            m, q, jnp.asarray(scales), jnp.asarray(eye), k))(
            means, jnp.asarray(quats), jnp.asarray(intr))
        out = rasterize_pallas_grad_batch(p, colors, opac, jnp.asarray(bg), 32, 32,
                                          tile=16, span_cap=4, interpret=True)
        return _raster_losses(out, 0), out

    (jv, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(means), jnp.asarray(opac), jnp.asarray(colors))
    m_, o_, c_ = t(means, True), t(opac, True), t(colors, True)
    proj = tc.project_splats(m_, t(quats), t(scales), t(eye), t(intr))
    out = tb.rasterize_batch(proj, c_, o_, t(bg), 32, 32, entry_cap=0)
    _raster_losses(out, 0).backward()
    for f in SMOOTH:
        assert_close(getattr(jout, f), getattr(out, f), 5e-4, 1e-3, f)
    for name, jgr, ta in zip(("xyz", "opacity", "colors"), jg, (m_, o_, c_)):
        assert_close(jgr, ta.grad, 1e-5, 1e-4, name)
