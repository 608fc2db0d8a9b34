"""Parity of the port's densify / prune / opacity-reset / outlier hooks, .ply
I/O, hook cadence and render-batch helpers with the JAX package, on the
same numpy state.

The split children's noise is the JAX package's own draw,
``jax.random.normal(PRNGKey(m), (capacity, 2, 2))``, passed to the port as
``noise``. Tolerances: masks, ``info`` counts and .ply bytes exactly equal;
float rows within 1e-6 (the same float32 formulas, evaluated by two
libraries: an ulp or two of values below 8); the outlier masks exactly
equal on a cloud with no pair within float32 rounding of the radius where
it would matter.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, n, t
from vidu4d_tpu.engine.gs4d_trainer import cadence_due as jcadence_due
from vidu4d_tpu.models.gaussian import densify as jdn
from vidu4d_tpu.models.gaussian import surfels as jsf
from vidu4d_tpu.models.gaussian.optimizer import GsAdamState as JAdam
from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init as jadam_init
from vidu4d_tpu.models.gaussian.ply_io import save_ply as jsave_ply
from vidu4d_tpu.ops import geometry as jgeom
from vidu4d_tpu.ops import quaternion as jq
from vidu4d_tpu.utils import camera_trajectories as jct
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.gs4d_trainer import cadence_due
from vidu4d_tpu_torch.models.gaussian import densify as tdn
from vidu4d_tpu_torch.models.gaussian import surfels as tsf
from vidu4d_tpu_torch.models.gaussian.ply_io import load_ply, save_ply
from vidu4d_tpu_torch.ops import geometry as tgeom
from vidu4d_tpu_torch.ops import quaternion as tq
from vidu4d_tpu_torch.utils import camera_trajectories as tct

INFO_KEYS = ("cloned", "split", "pruned", "dropped_children", "alive")


def _np_tree(x):
    return jax.tree.map(np.array, x)


def _make_state(rng, n=16, capacity=64, sh_degree=1):
    """tests/test_surfels.py's state."""
    pts = jnp.array(rng.normal(size=(n, 3)), jnp.float32)
    cols = jnp.array(rng.uniform(size=(n, 3)), jnp.float32)
    return jsf.init_from_points(pts, cols, capacity, sh_degree=sh_degree)


def _random_state(rng, capacity=4096, alive_frac=0.85, sh_degree=3, feat=16,
                  max_log10_scale=-0.7, max_radius=30.0):
    """A store where every rule fires: scales around percent_dense (clone
    and split), opacities below min_opacity, screen radii and world scales
    above the size thresholds, and more valid children than dead slots."""
    k = (sh_degree + 1) ** 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    params = jsf.SurfelParams(
        xyz=f(capacity, 3) * 0.3, features_dc=f(capacity, 1, 3),
        features_rest=f(capacity, k - 1, 3) * 0.1,
        scaling=np.log(10 ** rng.uniform(-3.3, max_log10_scale, (capacity, 2))).astype(np.float32),
        rotation=f(capacity, 4), opacity=(f(capacity, 1) * 2.0 - 2.0),
        regist_feat=f(capacity, feat))
    denom = rng.integers(0, 6, capacity).astype(np.float32)
    grads = 2e-4 * np.exp(rng.normal(size=capacity) * 1.0)
    state = jsf.SurfelState(
        params=jax.tree.map(jnp.asarray, params),
        alive=jnp.asarray(rng.uniform(size=capacity) < alive_frac),
        max_radii2d=jnp.asarray(rng.uniform(0, max_radius, capacity).astype(np.float32)),
        grad_accum=jnp.asarray((grads * denom).astype(np.float32)),
        denom=jnp.asarray(denom))
    adam = JAdam(count=jnp.asarray(7, jnp.int32),
                 mu=jax.tree.map(lambda x: jnp.asarray(f(*x.shape)), params),
                 nu=jax.tree.map(lambda x: jnp.asarray(np.abs(f(*x.shape))), params))
    return state, adam


def _port(state, adam):
    return (convert.surfel_state_from_jax(_np_tree(state), "cpu"),
            convert.gs_adam_from_jax(_np_tree(adam), "cpu"))


def _assert_state_equal(js, ja, ts, ta, what):
    assert np.array_equal(n(js.alive), n(ts.alive)), f"{what}: alive"
    for f in jsf.SurfelParams._fields:
        assert_close(getattr(js.params, f), getattr(ts.params, f), 1e-6, 0.0, f"{what}: {f}")
        assert_close(getattr(ja.mu, f), getattr(ta.mu, f), 1e-6, 0.0, f"{what}: mu.{f}")
        assert_close(getattr(ja.nu, f), getattr(ta.nu, f), 1e-6, 0.0, f"{what}: nu.{f}")
    for f in ("max_radii2d", "grad_accum", "denom"):
        assert np.array_equal(n(getattr(js, f)), n(getattr(ts, f))), f"{what}: {f}"


def _densify_both(state, adam, m, extent, max_screen_size=0.0, config=None):
    config = config or jdn.DensifyConfig()
    # eagerly, as the JAX trainer's hooks call it (under jit, XLA's FMA
    # contraction moves split positions by a few ulps)
    js, ja, jinfo = jdn.densify_and_prune(state, adam, jax.random.PRNGKey(m), extent=extent,
                                          max_screen_size=max_screen_size, config=config)
    ts, ta = _port(state, adam)
    noise = t(jax.random.normal(jax.random.PRNGKey(m), (state.capacity, 2, 2)))
    ts, ta, tinfo = tdn.densify_and_prune(ts, ta, noise, extent=extent,
                                          max_screen_size=max_screen_size,
                                          config=tdn.DensifyConfig(*config))
    assert {k: int(jinfo[k]) for k in INFO_KEYS} == {k: int(tinfo[k]) for k in INFO_KEYS}
    _assert_state_equal(js, ja, ts, ta, f"densify m={m}")
    return {k: int(tinfo[k]) for k in INFO_KEYS}


def _clone_split_case(rng):
    state = _make_state(rng, n=16, capacity=64)
    p = state.params
    scaling = p.scaling.at[0].set(jnp.log(0.001)).at[1].set(jnp.log(10.0))
    state = state._replace(params=p._replace(scaling=scaling),
                           grad_accum=state.grad_accum.at[0].set(1.0).at[1].set(1.0),
                           denom=state.denom.at[0].set(1.0).at[1].set(1.0))
    adam = jadam_init(state.params)
    adam = adam._replace(mu=jax.tree.map(lambda x: x + 7.0, adam.mu))
    return state, adam, dict(extent=1.0, config=jdn.DensifyConfig(grad_threshold=0.5,
                                                                   min_opacity=0.0))


def _opacity_prune_case(rng):
    state = _make_state(rng, n=16, capacity=64)
    opac = state.params.opacity.at[3].set(jsf.inverse_sigmoid(jnp.asarray(0.001)))
    state = state._replace(params=state.params._replace(opacity=opac))
    return state, jadam_init(state.params), dict(extent=1.0)


def _overflow_case(rng):
    state = _make_state(rng, n=63, capacity=64)
    state = state._replace(grad_accum=jnp.ones_like(state.grad_accum),
                           denom=jnp.ones_like(state.denom))
    return state, jadam_init(state.params), dict(
        extent=1e9, config=jdn.DensifyConfig(grad_threshold=0.5, min_opacity=0.0))


def _screen_size_case(rng):
    state = _make_state(rng, n=16, capacity=64)
    radii = rng.uniform(0, 40, 64).astype(np.float32)
    state = state._replace(max_radii2d=jnp.asarray(radii),
                           grad_accum=jnp.asarray(rng.uniform(0, 2, 64), jnp.float32),
                           denom=jnp.ones((64,), jnp.float32))
    return state, jadam_init(state.params), dict(
        extent=1.0, max_screen_size=20.0, config=jdn.DensifyConfig(grad_threshold=1.0))


@pytest.mark.parametrize("case,expect", [
    ("clone_split", {"cloned": 1, "split": 1, "alive": 18}),
    ("opacity_prune", {"pruned": 1, "alive": 15}),
    ("overflow", {"cloned": 63, "dropped_children": 62, "alive": 64}),
    ("screen_size", {}),
])
def test_densify_cases_match_jax(case, expect):
    """tests/test_surfels.py's three densify cases and a screen-size prune
    (max_screen_size 20): alive and info equal, rows within 1e-6. All four
    stores have 64 slots (the overflow case 63 alive), so the eager JAX
    densify compiles its operations once."""
    rng = np.random.default_rng(3)
    state, adam, kw = {"clone_split": _clone_split_case, "opacity_prune": _opacity_prune_case,
                       "overflow": _overflow_case, "screen_size": _screen_size_case}[case](rng)
    info = _densify_both(state, adam, m=0, **kw)
    assert expect.items() <= info.items(), info
    if case == "screen_size":
        # pruned by screen radius beyond the opacity rule
        op = np.asarray(jsf.get_opacity(state.params))[:, 0]
        by_size = np.asarray(state.alive) & (np.asarray(state.max_radii2d) > 20) & (op >= 0.005)
        assert by_size.any() and info["pruned"] >= by_size.sum()


@pytest.mark.parametrize("max_screen_size", [0.0, 20.0])
def test_densify_random_store_matches_jax(max_screen_size):
    """A random 4096-slot store in which clone, split, prune, child prune and
    overflow all occur."""
    rng = np.random.default_rng(11)
    # with the size rules, fewer splats over the size thresholds, so that
    # children still overflow the dead slots
    state, adam = (_random_state(rng, alive_frac=0.97, max_log10_scale=-0.95, max_radius=21.0)
                   if max_screen_size else _random_state(rng))
    info = _densify_both(state, adam, m=1300, extent=1.0, max_screen_size=max_screen_size)
    assert info["cloned"] > 0 and info["split"] > 0 and info["pruned"] > 0
    assert info["dropped_children"] > 0
    # some children were pruned (opacity or, with the size rule, world size)
    scale = np.exp(np.asarray(state.params.scaling))
    op = np.asarray(jsf.get_opacity(state.params))[:, 0]
    hot = np.asarray(state.alive) & (np.asarray(state.grad_accum)
                                     / np.maximum(np.asarray(state.denom), 1e-12) >= 2e-4)
    child_pruned = hot & (op < 0.005)
    if max_screen_size:
        child_pruned |= hot & (scale.max(-1) / 1.6 > 0.1)
    assert child_pruned.any()


def test_reset_opacity_and_prune_by_mask_match_jax():
    rng = np.random.default_rng(5)
    state, adam = _random_state(rng, capacity=512)
    js, ja = jdn.reset_opacity(state, adam)
    ts, ta = _port(state, adam)
    ts, ta = tdn.reset_opacity(ts, ta)
    _assert_state_equal(js, ja, ts, ta, "reset_opacity")
    assert (n(tsf.get_opacity(ts.params)) <= 0.01 + 1e-7).all()
    mask = rng.uniform(size=512) < 0.3
    assert np.array_equal(n(jdn.prune_by_mask(js, jnp.asarray(mask)).alive),
                          n(tdn.prune_by_mask(ts, t(mask)).alive))


def test_radius_outlier_mask_matches_jax():
    """Clusters of ~radius spread with isolated points around them, some of
    the slots dead. The clusters sit near the origin, where the rounding of
    |q|^2 + |p|^2 - 2 q.p is ~1e-9 of a unit and far below r^2 = 1.6e-5:
    no slot whose count is at the threshold has a pair within 1e-4 r^2 of
    the radius (checked in float64), so the masks must be equal."""
    rng = np.random.default_rng(9)
    centres = rng.uniform(-0.05, 0.05, (4, 3))
    pts = np.concatenate([c + rng.normal(size=(500, 3)) * 0.002 for c in centres]
                         + [rng.uniform(-0.2, 0.2, (600, 3))]).astype(np.float32)
    alive = rng.uniform(size=len(pts)) < 0.9
    r2 = 0.004 ** 2
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    count = ((d2 <= r2) & alive).sum(-1) - 1
    near = np.where(alive[None], np.abs(d2 - r2), np.inf).min(-1) < 1e-4 * r2
    assert not (near & alive & ((count == 19) | (count == 20))).any()
    jm = jdn.radius_outlier_mask(jnp.asarray(pts), jnp.asarray(alive), nb_points=20,
                                 radius=0.004)
    tm = tdn.radius_outlier_mask(t(pts), t(alive), nb_points=20, radius=0.004)
    assert np.array_equal(n(jm), n(tm))
    assert np.array_equal(n(tm), alive & (count < 20))
    assert n(tm).sum() > 500 and (alive & ~n(tm)).sum() > 1500


def test_add_densification_stats_matches_jax():
    rng = np.random.default_rng(4)
    state, _ = _random_state(rng, capacity=256)
    vg = rng.normal(size=(256, 2)).astype(np.float32)
    vis = rng.uniform(size=256) < 0.7
    radii = rng.uniform(0, 30, 256).astype(np.float32)
    js = jsf.add_densification_stats(state, jnp.asarray(vg), jnp.asarray(vis),
                                     jnp.asarray(radii))
    ts = tsf.add_densification_stats(_port(state, JAdam(0, state.params, state.params))[0],
                                     t(vg), t(vis), t(radii))
    for f in ("grad_accum", "denom", "max_radii2d"):
        assert_close(getattr(js, f), getattr(ts, f), 1e-6, 1e-6, f)


def test_cadence_due_matches_jax():
    """tests/test_stage3_trainer.py's table, and the JAX function on a grid."""
    assert cadence_due(100, 1, 100) == 100
    assert cadence_due(101, 1, 100) is None
    assert cadence_due(0, 1, 100) is None
    assert cadence_due(150, 75, 150) == 150
    assert cadence_due(225, 75, 150) is None
    assert cadence_due(300, 75, 150) == 300
    assert cadence_due(140, 70, 100) == 100
    assert cadence_due(210, 70, 100) == 200
    assert cadence_due(2025, 75, 2000) == 2000
    for it in range(0, 130):
        for span in (1, 2, 3, 7):
            for interval in (1, 5, 10, 30):
                assert cadence_due(it, span, interval) == jcadence_due(it, span, interval)


def _ply_params(rng, sh_degree=2):
    state = _make_state(rng, n=20, capacity=32, sh_degree=sh_degree)
    return _np_tree(state.params), np.array(state.alive)


def test_save_ply_bytes_equal_jax_and_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    for deg in (0, 2, 3):
        params, alive = _ply_params(rng, deg)
        jsave_ply(os.path.join(tmp_path, "j.ply"), params, alive)
        save_ply(os.path.join(tmp_path, "t.ply"), tsf.SurfelParams(*params), alive)
        with open(os.path.join(tmp_path, "j.ply"), "rb") as a, \
                open(os.path.join(tmp_path, "t.ply"), "rb") as b:
            assert a.read() == b.read()
        loaded, count = load_ply(os.path.join(tmp_path, "t.ply"))
        assert count == int(alive.sum())
        for f in tsf.SurfelParams._fields[:-1]:
            assert np.array_equal(getattr(params, f)[alive], getattr(loaded, f)), f
        assert loaded.regist_feat.shape == (count, 0)


def test_save_ply_of_an_empty_store(tmp_path):
    """A store whose surfels were all pruned writes a 0-vertex file; the JAX
    save_ply raises on it (reshape(0, -1))."""
    params, alive = _ply_params(np.random.default_rng(3))
    dead = np.zeros_like(alive)
    with pytest.raises(ValueError):
        jsave_ply(os.path.join(tmp_path, "j.ply"), params, dead)
    save_ply(os.path.join(tmp_path, "t.ply"), tsf.SurfelParams(*params), dead)
    loaded, count = load_ply(os.path.join(tmp_path, "t.ply"))
    assert count == 0 and loaded.features_rest.shape == (0, 8, 3)


def test_hxy_grid_se3_and_construct_batch_match_jax():
    assert_close(jgeom.hxy_grid(5, 7), tgeom.hxy_grid(5, 7), 0.0)
    se3 = np.concatenate([jct.get_rotating_cam(6, distance=2.5),
                          jct.get_orbit_camera(3), jct.get_fixed_cam(2, angle=30.0)])
    se3 = se3.astype(np.float32)
    jqq, jt = jq.se3_to_quaternion_translation(jnp.asarray(se3))
    tqq, tt = tq.se3_to_quaternion_translation(t(se3))
    assert_close(jqq, tqq, 1e-6)
    assert_close(jt, tt, 1e-6)
    field2cam = jct.get_bev_cam(jct.get_rotating_cam(3, distance=2.0), elev=60.0)
    assert np.array_equal(tct.get_bev_cam(tct.get_rotating_cam(3, distance=2.0), elev=60.0),
                          field2cam)
    kw = dict(inst_id=1, frameid_sub=np.array([0, 3, 5]), eval_res=8)
    for f2c, kint, c2r in ((None, None, None),
                           (field2cam, np.tile([10.0, 11.0, 4.0, 4.5], (3, 1)),
                            np.tile([2.0, 2.0, 0.5, 0.0], (3, 1)))):
        jb = jct.construct_batch(**kw, field2cam=f2c, camera_int=kint, crop2raw=c2r)
        tb = tct.construct_batch(**kw, field2cam=f2c, camera_int=kint, crop2raw=c2r,
                                 device="cpu")
        assert set(jb) == set(tb)
        for k in jb:
            assert n(tb[k]).dtype == np.asarray(jb[k]).dtype, k
            assert_close(jb[k], tb[k], 1e-6, 0.0, k)
