"""The tile side (`raster_tile`, JAX's `RasterizeConfig.tile`) in the port's
rasterizer at 8 and 32, against the JAX package on the CPU.

* `bin_splats_aligned` at each side against JAX's on a 48 x 40 frame (not a
  multiple of 32, so edge tiles are cut): every field exactly (integer
  layouts);
* `api.rasterize` (the plain versions on the CPU) against JAX
  `api.rasterize` with ``impl="tiles"`` at the same side and a per-tile
  budget above the densest tile (so it composites every entry, as the
  kernels do), at 48 x 40: the outputs within atol 5e-4 / rtol 1e-3 and the
  gradients within atol 1e-5 / rtol 1e-4, tests/test_torch_rasterize.py's
  bounds (the slab's affine intersection and the tiles path's cross
  product round differently);
* one Stage-3 `train_step` at ``raster_tile=8`` in the reduced
  configuration against the JAX trainer's (``raster_impl="tiles"``,
  ``raster_budget=2048``) from the same parameters and batch, with
  tests/test_torch_stage3_step.py's bounds: losses rtol 2e-5, gnorm and the
  Adam moments 1e-3 relative, the densify counts exact;
* other sides raise NotImplementedError naming 8, 16 and 32, before any
  launch;
* on a card (marker ``cuda``), both kernels against their plain versions at
  8 and 32 on a two-frame scene with flow channels, on a deep tile that is
  split into several work items, and on the work-item boundary cases of
  `chip_smoke.chain_batch`, with chip_smoke.py's bounds (forward
  5e-4 on the smooth channels, backward per grad-slab column). JAX is
  imported only by the tests that use it, so on a machine without it that
  case runs as ``python -m pytest --noconftest -o addopts= -m cuda
  tests/test_torch_raster_tile.py``.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.ops.rasterize import api as tapi
from vidu4d_tpu_torch.ops.rasterize import common as tc
from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

SIDES = (8, 32)
H, W = 40, 48
SMOOTH = ("color", "depth", "alpha", "normal", "distortion", "final_t")
BUDGET = 512  # the JAX tiles path's per-tile budget; the scene stays under it


def _t(x, grad=False):
    out = torch.tensor(np.asarray(x, np.float32))
    return out.requires_grad_(True) if grad else out


def _close(ref, got, atol, rtol, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=name)


def _scene(seed, n=120):
    """One camera's surfels in front of it at 48 x 40 (numpy float32): some
    splats span several 8-pixel tiles."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.5, 0.4, 0.6]) + np.array([0.0, 0.0, 3.0])
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(n, 2)) * 0.5) * 0.06
    opac = 1.0 / (1.0 + np.exp(-rng.normal(size=n)))
    colors = rng.uniform(size=(n, 3))
    intr = np.array([45.0, 45.0, W / 2.0, H / 2.0])
    bg = rng.uniform(size=3)
    f32 = lambda a: np.asarray(a, np.float32)
    return tuple(map(f32, (means, quats, scales, opac, colors, intr, bg)))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's rasterizer modules (imported here, not at the top:
    the card's host has no JAX)."""
    import jax
    import jax.numpy as jnp

    from vidu4d_tpu.ops.rasterize import api as japi
    from vidu4d_tpu.ops.rasterize import common as jc

    return jax, jnp, japi, jc


def _projections(jx, scene):
    jax, jnp, _, jc = jx
    means, quats, scales, _, _, intr, _ = scene
    eye = np.eye(4, dtype=np.float32)
    jp = jc.project_splats(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
                           jnp.asarray(eye), jnp.asarray(intr))
    tp = tc.project_splats(_t(means), _t(quats), _t(scales), _t(eye), _t(intr))
    return jp, tp


@pytest.mark.parametrize("side", SIDES)
def test_bin_splats_aligned_matches_jax_at_side(jx, side):
    _, _, _, jc = jx
    jp, tp = _projections(jx, _scene(1, n=300))
    jax = jx[0]
    jb = jax.jit(jc.bin_splats_aligned, static_argnums=range(1, 7))(jp, H, W, side, 4, 128, 0)
    got = tc.bin_splats_aligned(tp, H, W, side, 4, 128, 0)
    assert got.tile_start.shape == (-(-H // side) * -(-W // side),)
    for f in jc.TileBinning._fields:
        assert np.array_equal(np.asarray(getattr(jb, f)), getattr(got, f).numpy()), f


def _losses(out, lib):
    return (lib.mean(out.color ** 2) + 0.3 * lib.mean(out.depth) + 0.2 * lib.mean(out.alpha)
            + 0.1 * lib.mean(out.normal) + 0.5 * lib.mean(out.distortion))


@pytest.mark.parametrize("side", SIDES)
def test_rasterize_matches_jax_tiles_at_side(jx, side):
    """Values and gradients (to means, quats, scales, opacities, colours
    and bg) of one 48 x 40 camera at tile side ``side``."""
    jax, jnp, japi, _ = jx
    scene = _scene(2)
    means, quats, scales, opac, colors, intr, bg = scene
    eye = np.eye(4, dtype=np.float32)
    cfg = japi.RasterizeConfig(tile=side, budget=BUDGET, tile_chunk=4, impl="tiles")

    def jloss(*args):
        out = japi.rasterize(*args[:4], jnp.asarray(eye), jnp.asarray(intr), H, W,
                             colors=args[4], bg_color=args[5], config=cfg)
        return _losses(out, jnp), out

    (jv, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True))(
        *map(jnp.asarray, (means, quats, scales, opac, colors, bg)))
    targs = [_t(a, True) for a in (means, quats, scales, opac, colors, bg)]
    m_, q_, s_, o_, c_, b_ = targs
    before = dict(kernels.COUNTS)
    out = tapi.rasterize(m_, q_, s_, o_, _t(eye), _t(intr), H, W, colors=c_, bg_color=b_,
                         config=tapi.RasterizeConfig(tile=side, entry_cap=0))
    _losses(out, torch).backward()
    assert kernels.COUNTS["tile_forward_plain"] == before["tile_forward_plain"] + 1
    assert kernels.COUNTS["tile_backward_plain"] == before["tile_backward_plain"] + 1
    # every tile's entries fit the JAX budget, and some tile holds several
    proj = tc.project_splats(_t(means), _t(quats), _t(scales), _t(eye), _t(intr))
    counts = tc.bin_splats_aligned(proj, H, W, side).tile_count
    assert 8 <= int(counts.max()) < BUDGET
    assert out.color.shape == (H, W, 3)
    for f in SMOOTH:
        _close(getattr(jout, f), getattr(out, f), 5e-4, 1e-3, f)
    assert abs(float(jv) - float(_losses(out, torch).detach())) <= 3e-5 * abs(float(jv))
    for name, jgr, ta in zip(("xyz", "rot", "scale", "opacity", "colors", "bg"), jg, targs):
        assert float(ta.grad.abs().max()) > 0, name
        _close(jgr, ta.grad, 1e-5, 1e-4, name)


@pytest.mark.parametrize("side", [12, 4, 64])
def test_other_tile_sides_raise(side):
    """Sides without a kernel raise NotImplementedError naming the three,
    at the wrappers (before any launch) and at the batch's binning."""
    proj = tc.project_splats(*map(_t, _scene(3)[:3]), torch.eye(4), _t(_scene(3)[5]))
    colors, opac = _t(_scene(3)[4]), _t(_scene(3)[3])
    with pytest.raises(NotImplementedError, match="8, 16, 32"):
        tb.prepare_batch(tc.SplatProjection(*[x[None] for x in proj]), colors[None], opac,
                         torch.zeros(3), H, W, tile=side)
    b = tb.prepare_batch(tc.SplatProjection(*[x[None] for x in proj]), colors[None], opac,
                         torch.zeros(3), H, W)
    before = dict(kernels.COUNTS)
    with pytest.raises(NotImplementedError, match="8, 16, 32"):
        tf.forward_tiles(b["slab"], b["tile_start"], b["tile_count"], b["bg"], b["tiles_x"],
                         b["tiles_per_frame"], 0, side)
    cot = torch.zeros((b["tile_start"].shape[0], side * side, 10))
    with pytest.raises(NotImplementedError, match="8, 16, 32"):
        tb.backward_tiles(b["slab"], b["tile_start"], b["tile_count"], cot,
                          torch.zeros((b["tile_start"].shape[0], side * side, 4)),
                          b["tiles_x"], b["tiles_per_frame"], 0, side)
    assert kernels.COUNTS == before


# ---- one Stage-3 step at raster_tile 8 against the JAX trainer

RES = 32


@pytest.fixture(scope="module")
def step8(tmp_path_factory, jx):
    """One reduced-configuration step of both trainers at raster_tile 8 from
    the same converted parameters, surfels and batch
    (tests/test_torch_stage3_step.py's setup; the JAX trainer's flax init
    runs under jit)."""
    jax = jx[0]
    from tests.helpers import make_fake_db
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.engine.schedules import progress_schedule
    from vidu4d_tpu.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu_torch import convert
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer as TTrainer

    tmp = tmp_path_factory.mktemp("raster_tile")
    db = make_fake_db(tmp, num_vids=1, T=8, H=RES, W=RES)
    opts = {"dataroot": db, "seqname": "toy", "logname": "tile8",
            "logroot": os.path.join(str(tmp), "logdir"), "data_prefix": "crop",
            "train_res": RES, "pixels_per_image": -1, "imgs_per_gpu": 1,
            "fg_motion": "gs-bob", "gs_capacity": 448, "gs_init_samples": 400,
            "sh_degree": 3, "gs_optim_warp": False, "rgb_loss_only": True, "flow_wt": 0.0,
            "raster_tile": 8}
    def init_params(self):  # the flax init under jit: ~3x faster than eagerly
        batch = self._next_batch()
        self.params = jax.jit(lambda key: self.deformer.init(
            key, method=lambda mdl: self._model_forward_for_init(mdl, batch)))(
                jax.random.PRNGKey(0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_params", init_params)
        jt = JTrainer({**opts, "raster_impl": "tiles", "raster_budget": 2048,
                       "raster_tile_chunk": 4})
    prior = np.tile(np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32), (8, 1))
    p = dict(jt.params["params"])
    p["intrinsics"] = init_intrinsics_base_params(
        {"params": p["intrinsics"]}, prior, jt.frame_info)["params"]
    jt.params = {**jt.params, "params": p}
    batch = jt._next_batch()
    weights = progress_schedule({**jt._loss_config(), "reg_eikonal_wt": 0.0}, 1000)
    before = jax.tree.map(np.array, (jt.params, jt.surfels, jt.gs_adam))
    _, js, ja, _, jm = jt._train_step(jt.params, jt.surfels, jt.gs_adam,
                                      jt.warp_opt_state, batch, weights)
    jax_out = jax.tree.map(np.asarray, (js, ja, jm))

    tt = TTrainer(opts, "cpu")
    convert.load_flax_params_(tt.deformer, before[0])
    tt.set_surfels(convert.surfel_state_from_jax(before[1], "cpu"))
    tt.gs_adam = convert.gs_adam_from_jax(before[2], "cpu")
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        prepared, _ = tt.render_inputs(tbatch)
    tm = tt.train_step(tbatch)
    return jax_out, tt, tm, prepared


def test_stage3_step_at_tile_8_matches_jax(step8):
    (js, ja, jm), tt, tm, prepared = step8
    assert tt.raster_cfg.tile == 8 and prepared["tile"] == 8
    assert prepared["tiles_x"] == RES // 8 and int(prepared["tile_count"].max()) < 2048
    assert int(jm["alive"]) == int(tm["alive"]) == 400
    for k in ("total", "rgb", "mask", "depth"):
        _close(jm[k], tm[k], 0.0, 2e-5, k)
    _close(jm["gnorm"], tm["gnorm"], 0.0, 1e-3, "gnorm")
    assert np.isfinite(float(tm["gnorm"])) and float(tm["gnorm"]) > 0
    assert int(jm["overflow_splats"]) == int(tm["overflow_splats"])
    for f in js.params._fields:
        if f == "regist_feat":
            continue
        mu_j, mu_t = np.asarray(getattr(ja.mu, f)), getattr(tt.gs_adam.mu, f).numpy()
        assert np.abs(mu_j - mu_t).max() <= 1e-3 * np.abs(mu_j).max(), f"mu.{f}"
    # the densify statistics' tile rects at side 8
    assert np.array_equal(np.asarray(js.denom), tt.surfels.denom.numpy())
    assert np.array_equal(np.asarray(js.max_radii2d), tt.surfels.max_radii2d.numpy())


def test_trainer_records_the_tile_side(step8):
    """The side is in the run's opts.json (render / export / reanimate
    --logdir render at it) and reaches the eval render."""
    import json

    _, tt, _, _ = step8
    with open(os.path.join(tt.save_dir, "opts.json")) as f:
        assert json.load(f)["raster_tile"] == 8
    from vidu4d_tpu_torch.utils.camera_trajectories import construct_batch

    batch = construct_batch(inst_id=0, frameid_sub=np.arange(2), eval_res=RES,
                            field2cam=None, camera_int=None, crop2raw=None, device="cpu")
    out = tt.render_batch(batch, res=RES)
    assert out["rendered"].shape == (2, RES, RES, 3) and np.isfinite(out["rendered"]).all()


# ---- the kernels on the card


def _cuda_case(case, side):
    rng = np.random.default_rng(11)
    if case == "item boundaries X=2":
        return chip_smoke.chain_batch(rng, tf.SEG, 2, "cuda", tile=side)
    kw = {"64x64 2 frames X=2": dict(n=3000, res=64, frames=2, n_extra=2),
          "deep tile": dict(n=2000, res=64, frames=1, n_extra=0, deep=True)}[case]
    with torch.no_grad():
        proj, colors, opac, bg = chip_smoke.random_scene(rng, device="cuda", tile=side, **kw)
        return tb.prepare_batch(proj, colors, opac, bg, kw["res"], kw["res"], tile=side)


@pytest.mark.cuda
@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("case", ["64x64 2 frames X=2", "deep tile", "item boundaries X=2"])
def test_cuda_kernels_match_plain_at_side(case, side):
    """Both kernels at tile side ``side`` vs their plain versions (needs
    nvcc + a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    b = _cuda_case(case, side)
    items = tf.work_list(b["tile_count"], b["slab"].shape[0])[0]
    if case != "64x64 2 frames X=2":  # a tile split into several work items
        assert int((items[1:] - items[:-1]).max()) >= 2
    geo = (b["tiles_x"], b["tiles_per_frame"], b["n_extra"], side)
    fw = (b["slab"], b["tile_start"], b["tile_count"], b["bg"])
    got = tf.forward_tiles(*fw, *geo)
    assert got[0].shape == (b["tile_start"].shape[0], side * side, 3 + b["n_extra"])
    chip_smoke.check_forward(tf.forward_tiles_plain(*fw, *geo), got, f"{case} tile {side}")
    cot = torch.randn((b["tile_start"].shape[0], side * side, 10 + b["n_extra"]),
                      device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    bw = (b["slab"], b["tile_start"], b["tile_count"], cot, got[1][..., 8:12].contiguous())
    chip_smoke.check_backward(tb.backward_tiles_plain(*bw, *geo), tb.backward_tiles(*bw, *geo),
                              f"{case} tile {side}")
