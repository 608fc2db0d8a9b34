"""The port's Stage-3 round loop against the JAX Stage3Trainer's, on the CPU:
the hook schedule, a whole `train_one_round` with every hook, the eval
render and the checkpoint (the rollback, which both trainers share, in
tests/test_torch_rounds.py).

One JAX trainer (32x32, default configuration, raster_impl="tiles" with a
per-tile budget above the densest tile, so it composites every entry as the
port's tile compositor does) serves the module; its step compiles once.
The port gets its state converted, the same batches and the JAX split
noise (`jax.random.normal(PRNGKey(m), (capacity, 2, 2))` through
`Stage3Trainer._split_noise`).

The whole round (8 steps; densify at 4 and 8, opacity reset at 6, the
outlier prune at 8, the size rules on at 8): densify's decisions follow
grad_accum / denom, which the two packages sum in another order (~7.5e-4
relative after 2 steps, tests/test_torch_stage3_full_step.py). So
densify_grad_threshold sits in the widest gap of JAX's mean gradients just
before the first densify (read from a probe of step 4), and the test
requires: the alive mask equal after that densify; alive within 0.1% of
capacity after the round; the last step's losses within 1e-3 relative.
Measured (JAX / port): threshold 1.005e-3 in a gap of 15.9%; after the
densify at 4 (6 splits) alive 1542 / 1542 with equal masks; after the
round (the outlier prune took 1048) 494 / 494 of capacity 2048; last-step
losses within 8.7e-6 relative, gnorm 1.1e-4.

The eval render uses test_torch_rasterize.py's bounds for the same
outputs: colour, alpha, depth, normal atol 5e-4 / rtol 1e-3; the median
depth, which that file leaves out as discontinuous, on >= 99.5% of pixels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import assert_close, n, t
from vidu4d_tpu.models.gaussian import densify as jdn
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer as TTrainer
from vidu4d_tpu_torch.models.gaussian import densify as tdn
from vidu4d_tpu_torch.utils import camera_trajectories as tct

RES, CAP, N_INIT = 32, 2048, 1536
CADENCE = {"densify_from_iter": 3, "densification_interval": 4,
           "opacity_reset_interval": 6, "outlier_filtering_interval": 8}


def _opts(db, tmp, name, **extra):
    return {"dataroot": db, "seqname": "toy", "logname": name,
            "logroot": os.path.join(str(tmp), "logdir"), "data_prefix": "crop",
            "train_res": RES, "pixels_per_image": -1, "imgs_per_gpu": 1,
            "fg_motion": "gs-bob", "gs_capacity": CAP, "gs_init_samples": N_INIT,
            "sh_degree": 3, "feat_reproj_px": 256, **extra}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX trainer at its initial state (pixel-true intrinsics, a cloud of
    two tight clusters and a sparse halo, 16-dim registration features),
    that state as numpy, and a converter to port trainers."""
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu.models.gaussian import surfels as jsf
    from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init

    tmp = tmp_path_factory.mktemp("round_loop")
    db = make_fake_db(tmp, num_vids=1, T=8, H=RES, W=RES)
    jt = JTrainer({**_opts(db, tmp, "jax"), "raster_impl": "tiles",
                   "raster_budget": CAP, "raster_tile_chunk": 4})
    prior = np.tile(np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32), (8, 1))
    p = dict(jt.params["params"])
    p["intrinsics"] = init_intrinsics_base_params(
        {"params": p["intrinsics"]}, prior, jt.frame_info)["params"]
    jt.params = {**jt.params, "params": p}
    rng = np.random.default_rng(7)
    k = N_INIT // 4
    pts = np.concatenate([rng.normal(size=(k, 3)) * 0.004 + [0.02, 0.0, 0.0],
                          rng.normal(size=(k, 3)) * 0.004 - [0.02, 0.0, 0.0],
                          rng.normal(size=(N_INIT - 2 * k, 3)) * 0.05]).astype(np.float32)
    feats = rng.normal(size=(N_INIT, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    jt.surfels = jsf.init_from_points(
        jnp.asarray(pts), jnp.asarray(rng.uniform(size=(N_INIT, 3)), jnp.float32), CAP,
        sh_degree=3, key=jax.random.PRNGKey(0), regist_feat=jnp.asarray(feats))
    jt.gs_adam = gs_adam_init(jt.surfels.params)
    before = jax.tree.map(np.array, (jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state))
    # strongly typed leaves (the deformer's init leaves some weakly typed, and
    # the step would compile again once its outputs come back strong)
    jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state = jax.tree.map(jnp.asarray, before)

    def port(name, **extra):
        tt = TTrainer(_opts(db, tmp, name, **extra), "cpu")
        convert.load_flax_params_(tt.deformer, before[0])
        tt.set_surfels(convert.surfel_state_from_jax(before[1], "cpu"))
        tt.gs_adam = convert.gs_adam_from_jax(before[2], "cpu")
        tt.warp_opt.load_state(convert.warp_adamw_from_optax(before[3], tt.deformer, "cpu"))
        return tt

    return jt, port, before


def _jax_noise(m, shape):
    return t(jax.random.normal(jax.random.PRNGKey(m), shape))


@pytest.fixture(scope="module")
def whole_round(setup):
    """Rounds of 3 and 5 steps through both trainers from the same state
    and batches; the alive masks after each densify."""
    jt, port, _ = setup
    tt = port("port_round")
    tt._split_noise = _jax_noise
    batches = [jt._next_batch() for _ in range(8)]
    jfeed = iter(batches)
    tfeed = iter([{k: torch.tensor(np.asarray(v)) for k, v in b.items()} for b in batches])
    jt._next_batch = lambda: next(jfeed)
    tt._next_batch = lambda: next(tfeed)
    for o in (jt.opts, tt.opts):
        o.update(CADENCE, iters_per_round=3)
    jt.train_one_round()
    tt.train_one_round()

    # probe: JAX's mean gradients just before the densify at step 4
    cfg = jt._loss_config()
    probe = jt._train_step(jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state,
                           batches[3], jt._step_weights(cfg, 3), use_2dgs_reg=False)[1]
    alive, denom = np.asarray(probe.alive), np.asarray(probe.denom)
    g = np.log(np.asarray(probe.grad_accum)[alive & (denom > 0)]
               / denom[alive & (denom > 0)])
    g = np.sort(g)
    lo, hi = len(g) // 2, int(0.97 * len(g))
    i = lo + int(np.argmax(g[lo + 1:hi] - g[lo:hi - 1]))
    thr = float(np.exp(0.5 * (g[i] + g[i + 1])))
    gap = float(np.exp(g[i + 1] - g[i]) - 1.0)

    masks = {"jax": [], "port": []}

    def spy(mod, key):
        orig = mod.densify_and_prune

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            masks[key].append(n(out[0].alive).copy())
            return out
        return wrapped

    for o in (jt.opts, tt.opts):
        o.update(iters_per_round=5, densify_grad_threshold=thr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdn, "densify_and_prune", spy(jdn, "jax"))
        mp.setattr(tdn, "densify_and_prune", spy(tdn, "port"))
        jm = jt.train_one_round()
        tm = tt.train_one_round()
    return jt, tt, masks, jm, tm, (thr, gap)


def test_train_one_round_matches_jax(whole_round):
    jt, tt, masks, jm, tm, (thr, gap) = whole_round
    assert jt.current_steps == tt.current_steps == 8
    assert gap > 0.01, (thr, gap)
    assert [e["hook"] for e in tt.hook_log] == ["densify", "reset_opacity", "densify",
                                                "outlier"]
    assert len(masks["jax"]) == len(masks["port"]) == 2
    # the densify at 4 changed the store, and both packages equally
    first = masks["port"][0]
    assert np.array_equal(masks["jax"][0], first)
    info = tt.hook_log[0]
    assert int(info["cloned"]) + int(info["split"]) > 0 and int(info["alive"]) == first.sum()
    ja, ta = int(np.asarray(jt.surfels.alive).sum()), int(n(tt.surfels.alive).sum())
    assert abs(ja - ta) <= 1e-3 * CAP, (ja, ta)
    assert int(tt.hook_log[-1]["pruned"]) > 0
    assert (n(tt.surfels.params.opacity)[first] < 0).all()  # reset at 6: <= 0.01 then 2 steps
    for k in jm:
        if k in ("alive", "overflow_splats", "truncated_entries"):
            assert int(jm[k]) == int(tm[k]), k
        else:
            assert_close(jm[k], tm[k], 1e-9, 1e-3, f"last step {k}")


def _hook_spies(mp, events, trainer, mod, split_m):
    """Stand-ins of the hook functions that record (hook, current_steps,
    arguments) and change nothing; split_m() gives the densify's step m."""
    def densify(state, adam, key_or_noise, extent, max_screen_size=0.0, config=None):
        events.append(("densify", trainer.current_steps,
                       (split_m(key_or_noise), extent, max_screen_size, tuple(config))))
        return state, adam, {}

    def reset(state, adam, ceiling=0.01):
        events.append(("reset_opacity", trainer.current_steps, ceiling))
        return state, adam

    def outlier(xyz, alive, nb_points=20, radius=0.004):
        events.append(("outlier", trainer.current_steps, (nb_points, radius)))
        return alive & False

    for name, fn in (("densify_and_prune", densify), ("reset_opacity", reset),
                     ("radius_outlier_mask", outlier)):
        mp.setattr(mod, name, fn)


@pytest.mark.parametrize("k", [1, 3])
def test_hook_schedule_matches_jax(setup, k):
    """The hooks the two round loops fire (hook, step, arguments) and the
    log_fn calls over 3 rounds of 40 steps, for iters_per_dispatch 1 and 3
    (chunks 3 x 13 + 1). The steps themselves are stubbed."""
    jt, port, _ = setup
    tt = port(f"port_schedule_{k}")
    cadence = {"densify_from_iter": 5, "densification_interval": 7,
               "opacity_reset_interval": 20, "outlier_filtering_interval": 13,
               "densify_until_iter": 100, "outlier_stop_iter": 110,
               "iters_per_round": 40, "iters_per_dispatch": k,
               "densify_grad_threshold": 2e-4}
    events = {"jax": [], "port": []}
    logs = {"jax": [], "port": []}
    metrics_j = {"gnorm": jnp.float32(0.0)}
    metrics_t = {"gnorm": torch.tensor(0.0)}
    split_ms = []

    def jstep(p, s, a, w, *args, **kw):
        return p, s, a, w, metrics_j

    def tstep():
        tt.current_steps += 1
        return metrics_t

    def tnoise(m, shape):
        split_ms.append(m)
        return torch.zeros(shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "opts", {**jt.opts, **cadence})
        mp.setattr(jt, "current_steps", 0)
        mp.setattr(jt, "_train_step", jstep)
        mp.setattr(jt, "_train_chunk", lambda bs, ws, reg: jstep(
            jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state))
        mp.setattr(jt, "_next_batch", lambda: None)
        tt.opts.update(cadence)
        tt.train_step = tstep
        tt._split_noise = tnoise
        _hook_spies(mp, events["jax"], jt, jdn, lambda key: int(np.asarray(key)[-1]))
        _hook_spies(mp, events["port"], tt, tdn, lambda noise: split_ms[-1])
        for _ in range(3):
            jt.train_one_round(log_fn=lambda s, m: logs["jax"].append(s))
            tt.train_one_round(log_fn=lambda s, m: logs["port"].append(s))
        assert jt.current_steps == tt.current_steps == 120
    assert {e[0] for e in events["jax"]} == {"densify", "reset_opacity", "outlier"}
    assert events["port"] == events["jax"]
    assert logs["port"] == logs["jax"] == [100 if k == 1 else 101]
    assert [e["step"] for e in tt.hook_log if e["hook"] == "densify"] == \
        [e[2][0] for e in events["jax"] if e[0] == "densify"]


@pytest.mark.parametrize("case", ["default", "field2cam_no_warp"])
def test_render_batch_matches_jax(setup, case):
    """render_batch from the same state: the trainer's camera at frames 0 and
    3, or a given field2cam + intrinsics with the canonical surfels."""
    from vidu4d_tpu.utils import camera_trajectories as jct

    jt, port, before = setup
    tt = port(f"port_render_{case}")
    kw = dict(inst_id=0, frameid_sub=np.array([0, 3]), eval_res=RES, field2cam=None,
              camera_int=None, crop2raw=None)
    no_warp = case != "default"
    if no_warp:
        kw.update(field2cam=jct.get_rotating_cam(2, distance=0.4, max_angle=30.0),
                  camera_int=np.tile([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], (2, 1)))
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer at the port's state
        mp.setattr(jt, "params", jax.tree.map(jnp.asarray, before[0]))
        mp.setattr(jt, "surfels", jax.tree.map(jnp.asarray, before[1]))
        jout = jt.render_batch(jct.construct_batch(**kw), res=RES, no_warp=no_warp)
    tout = tt.render_batch(tct.construct_batch(**kw, device="cpu"), res=RES, no_warp=no_warp)
    assert set(jout) == set(tout)
    for k in ("rendered", "mask", "depth", "normal"):
        assert jout[k].shape == tout[k].shape == (2, RES, RES, jout[k].shape[-1]), k
        assert_close(jout[k], tout[k], 5e-4, 1e-3, k)
    assert (tout["mask"] > 0.01).mean() > 0.05  # the cloud is in view
    ok = np.isclose(tout["median_depth"], jout["median_depth"], atol=5e-4, rtol=1e-3)
    assert ok.mean() >= 0.995, ok.mean()


def _state(tt):
    """Clones of the trainer's state by name, with the surfel Adam's count
    (not the warp AdamW's: checkpoints leave it out)."""
    s, a = tt.surfels, tt.gs_adam
    out = {f"surfels.{i}": x.detach().clone() for i, x in enumerate((*s.params, *s[1:]))}
    out.update({f"adam.{i}": x.clone() for i, x in enumerate((*a.mu, *a.nu))})
    out.update({f"deformer.{k}": v.clone() for k, v in tt.deformer.state_dict().items()})
    out["adam.count"] = torch.tensor(a.count)
    return out


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_round_trip(setup, tmp_path):
    """save_checkpoint, then load_checkpoint into a fresh trainer: the same
    surfel store, Adam moments and deformer, and the same loss on the next
    step; the payload needs neither torch nor the port to read."""
    import pickle

    _, port, _ = setup
    tt = port("port_ckpt", num_rounds=1, iters_per_round=2,
              densify_from_iter=0, densification_interval=2)
    tt._split_noise = _jax_noise
    tt.train()
    names = set(os.listdir(tt.save_dir))
    assert {"ckpt_0001.pth", "ckpt_latest.pth", "point_cloud_0001.ply", "opts.json"} <= names
    fresh = port("port_ckpt_fresh")
    payload = fresh.load_checkpoint(os.path.join(tt.save_dir, "ckpt_0001.pth"),
                                    reset_steps=False)
    assert (fresh.current_steps, fresh.current_round) == (2, 1)
    assert _equal(_state(tt), _state(fresh))
    assert fresh.gs_adam.count == 2
    with open(os.path.join(tt.save_dir, "ckpt_latest.pth"), "rb") as f:
        data = f.read()
    assert pickle.loads(data).keys() == payload.keys() == {
        "current_steps", "current_round", "params", "surfels", "gs_adam", "opts"}
    assert b"torch" not in data and b"vidu4d_tpu" not in data
    batch = tt._next_batch()
    m1, m2 = tt.train_step(batch), fresh.train_step(batch)
    for k in m1:
        assert_close(m1[k], m2[k], 0.0, 1e-6, k)
