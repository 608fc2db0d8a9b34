"""The port's Stage-2 trainer (vidu4d_tpu_torch/engine/trainer.py), its
sampled-pixel data path and its command line against the JAX package's
Stage2Trainer, on the CPU.

One JAX Stage2Trainer serves the module (16 x 16 fake database, 2 pairs x
4 pixels, field depth 2 / width 32, 8 samples, seed -1 as the CLI's
default). Its flax init (an eager pass through the whole loss, ~50 s on
the CPU) is replaced by the port trainer's seeded parameters, converted
(`convert.dvr_flax_from_state_dict`); it still draws its init batch, so
the batchers of both trainers stay in step. Its train step compiles once.

Tolerances (float32): batches bit-equal; the total loss within 1e-4
relative, each term within 1e-3 (the eikonal term differentiates the SDF
through the 10-band encoding at canonical points that differ by float32
rounding: 6.5e-4 measured) and gnorm within 1e-3 (test_torch_dyn_nerf.py:
the camera gradients are ill-conditioned in float32); after the first
AdamW update each parameter within 2 x its step (lr x multiplier: Adam's
first step is ~lr * g / |g|, which flips sign where g is noise), and the
optimiser fed JAX's clipped gradients within 1e-6 of a step of JAX's
update; the prior fits take the same number of steps, end within 1e-3
relative, and the fitted MLPs' outputs agree within 1e-4 of their largest
magnitude; after 5 SDF pretrain steps with JAX's draws the SDF and the
visibility at 1000 points agree within 1e-4 of their largest magnitude
(parameters are not compared one by one: where a gradient is ~eps, Adam's
g / (|g| + eps) moves an element by up to lr on rounding alone);
update_geometry_aux on one SDF grid: from the initial state the same
proxy mesh faces, its vertices (interpolated in either package), aabb,
near/far and proxy points within 1e-6; from the blended state (whose
extended aabb rounds differently) the vertex count within 0.1%, the aabb
within 1e-6, near/far within 1e-3 relative (other proxy points on the same
surface); checkpoints bitwise; a render in chunks within
1e-6 of the whole one ("vis" is re-normalised across chunks).
"""

import copy
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import n, t
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.optim import lr_multiplier, make_stage2_optimizer
from vidu4d_tpu_torch.engine.schedules import progress_schedule
from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState

LR = 5e-4


def _opts(db, root, logname):
    return {"dataroot": db, "seqname": "toy", "logname": logname, "logroot": root,
            "data_prefix": "crop", "train_res": 16, "pixels_per_image": 4, "imgs_per_gpu": 2,
            "num_rounds": 2, "iters_per_round": 2, "save_freq": 1, "fg_motion": "bob",
            "field_depth": 2, "field_width": 32, "train_depth_samples": 8,
            "learning_rate": LR, "seed": -1}


def _jax_trainer(opts, params):
    """The JAX Stage2Trainer of ``opts`` with ``params`` (a numpy flax tree)
    in place of its flax init."""
    from vidu4d_tpu.engine.trainer import Stage2Trainer as JTrainer

    def init_params(self):
        self._example_batch()
        self.params = jax.tree.map(jnp.asarray, params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_params", init_params)
        return JTrainer(opts)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2")
    db = make_fake_db(root, num_vids=1, T=8, H=16, W=16)
    logroot = os.path.join(str(root), "logdir")
    tt = Stage2Trainer(_opts(db, logroot, "port"), "cpu")
    params = convert.dvr_flax_from_state_dict(tt.model.state_dict())
    jt = _jax_trainer(_opts(db, logroot, "jax"), params)
    return SimpleNamespace(db=db, root=str(root), logroot=logroot, tt=tt, jt=jt,
                           params=params)


def _port(run, logname):
    """A fresh port trainer: the same seed, so the same parameters as
    ``run.tt``'s."""
    return Stage2Trainer(_opts(run.db, run.logroot, logname), "cpu")


def _jax_copy(run):
    """A shallow copy of the shared JAX trainer (its compiled step) whose
    parameters and field states can be replaced."""
    jt = copy.copy(run.jt)
    jt.states = dict(jt.states)
    return jt


def _to_torch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _jax_draws(step):
    """JAX's reg_losses draws of step ``step`` (`model.py:169`)."""
    k_vis, k_gauss, _, k_inst = jax.random.split(jax.random.PRNGKey(step), 4)
    return {"vis": t(jax.random.uniform(k_vis, (512, 3))),
            "inst": torch.as_tensor(np.asarray(jax.random.randint(k_inst, (512,), 0, 1))),
            "gauss": t(jax.random.uniform(k_gauss, (2048, 3)))}


def _flat(tree):
    return {"/".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_sampled_pixel_batches_match_jax(run):
    """Three training batches of fresh trainers (pixels_per_image 4, seed
    -1) are bit-equal, keys and dtypes too."""
    from vidu4d_tpu.data import data_utils as jdata
    from vidu4d_tpu_torch.data import data_utils as tdata

    tt = _port(run, "port_b")
    jt = _jax_trainer(_opts(run.db, run.logroot, "jax_b"), run.params)
    for _ in range(3):
        a = jdata.compute_frameid(jdata.flatten_pairs(jt.batcher.next_batch()), jt.frame_info)
        b = tdata.compute_frameid(tdata.flatten_pairs(tt.batcher.next_batch()), tt.frame_info)
        assert a.keys() == b.keys()
        assert a["hxy"].shape == (4, 4, 3)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k


def test_trainer_runs_on_the_card_by_default(run):
    """Stage2Trainer(opts) takes the card; without CUDA it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Stage2Trainer(_opts(run.db, run.logroot, "port_cuda"))


def test_stage3_dataset_rng_matches_jax_for_negative_seed(run):
    """The Stage-3 trainer at the command line's default seed -1 draws the
    JAX Stage-3 trainer's pairs: its datasets' rng is seeded with seed + 1
    (`data_utils.py:38-42`), its batcher with max(seed, 0)."""
    from vidu4d_tpu.data import data_utils as jdata
    from vidu4d_tpu_torch.data import data_utils as tdata
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer

    opts = {**_opts(run.db, run.logroot, "s3_rng"), "fg_motion": "gs-bob",
            "pixels_per_image": -1, "imgs_per_gpu": 4, "gs_capacity": 64,
            "gs_init_samples": 32}
    s3 = Stage3Trainer(opts, "cpu")
    jds = jdata.build_datasets(opts)
    ref = jdata.PairBatcher(jds, 4, seed=0, num_hosts=1, host_id=0)
    for _ in range(5):
        a = jdata.flatten_pairs(ref.next_batch())
        b = tdata.flatten_pairs(s3.batcher.next_batch())
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_train_step_matches_jax(run):
    """One step from the same parameters, state and batch with JAX's draws:
    every loss term, gnorm, the parameters after the AdamW update; and the
    optimiser alone on JAX's clipped gradients against JAX's update."""
    jt, tt = _jax_copy(run), _port(run, "port_s")
    batch = jt._example_batch()
    weights = progress_schedule(tt._loss_config(), 0)
    params, opt_state, jtot, jld, jgnorm = jt._train_step(
        jt.params, jt.opt_state, jt.states, batch, weights, jax.random.PRNGKey(0))
    before = {k: p.detach().clone() for k, p in tt.model.named_parameters()}
    m = tt.train_step(_to_torch(batch), draws=_jax_draws(0))
    assert set(m) == set(jld) | {"total", "gnorm"}
    for k in jld:
        np.testing.assert_allclose(float(m[k]), float(jld[k]), rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["total"]), float(jtot), rtol=1e-4)
    np.testing.assert_allclose(float(m["gnorm"]), float(jgnorm), rtol=1e-3)
    step = LR / 25.0  # OneCycle's first learning rate
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(convert.dvr_flax_from_state_dict(tt.model.state_dict()))
    names = convert.dvr_flax_from_state_dict(
        {k: torch.full((1,), lr_multiplier(k)) for k in before})
    mult = {k: float(v[0]) for k, v in _flat(names).items()}
    assert ref.keys() == got.keys()
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 2 * step * mult[k], k
    start = _flat(run.params)
    assert ({k for k in ref if np.array_equal(ref[k], start[k])}
            == {k for k in got if np.array_equal(got[k], start[k])})

    # the optimiser alone: JAX's clipped gradients (its Adam mu / 0.1)
    adam = [s for s in opt_state if hasattr(s, "mu")][0]
    grads = convert.dvr_state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x) / 0.1,
                                                          adam.mu))
    model = copy.deepcopy(run.tt.model)
    opt = make_stage2_optimizer(model, LR, total_steps=4, num_rounds=2)
    for k, p in model.named_parameters():
        p.grad = grads[k].clone()
    opt.step()
    got = _flat(convert.dvr_flax_from_state_dict(model.state_dict()))
    for k in ref:  # 1e-6 of a step, and the rounding of the parameter itself
        np.testing.assert_allclose(got[k], ref[k], rtol=2.5e-7, atol=1e-6 * step * mult[k],
                                   err_msg=k)
    mu = _flat(jax.tree.map(np.asarray, adam.mu))
    got_mu = _flat(convert.dvr_flax_from_state_dict(opt.mu))
    for k in mu:
        np.testing.assert_allclose(got_mu[k], mu[k], rtol=1e-6, atol=1e-12, err_msg=k)


def test_fit_to_prior_matches_jax(run):
    """mlp_init's prior fits (intrinsics to loss 1, the camera to 1e-4)
    from the same parameters: the same step counts, losses and fitted
    parameters."""
    from vidu4d_tpu.models.fields import time_mlp as jtm

    from vidu4d_tpu_torch.models.fields import time_mlp as ttm

    jt, tt = run.jt, _port(run, "port_f")

    fi = tt.frame_info
    intr = tt.model.intrinsics
    ttm.init_intrinsics_base_params(intr, tt.data_info["intrinsics"], fi)
    cam = tt.model.fields["fg"].camera_mlp
    ttm.init_camera_base_params(cam, tt.rt_scaled, fi)
    tree = convert.dvr_flax_from_state_dict(tt.model.state_dict())["params"]
    prior_i = jnp.asarray(tt.data_info["intrinsics"])
    prior_c = jnp.asarray(tt.rt_scaled[np.asarray(fi.frame_mapping)])
    ji = jtm.IntrinsicsMLP(frame_info=jt.frame_info)
    jc = jtm.CameraMLP(frame_info=jt.frame_info)
    cases = [
        (ji, {"params": tree["intrinsics"]}, lambda m, p: jtm.intrinsics_prior_loss(m, p, prior_i),
         intr, lambda: ttm.intrinsics_prior_loss(intr, torch.as_tensor(np.asarray(prior_i))),
         1.0),
        (jc, {"params": tree["fields_fg"]["camera_mlp"]},
         lambda m, p: jtm.camera_prior_loss(m, p, prior_c), cam,
         lambda: ttm.camera_prior_loss(cam, torch.as_tensor(np.asarray(prior_c))), 1e-4),
    ]
    for jmod, jparams, jloss, tmod, tloss, term in cases:
        jp, jl, js = jtm.fit_to_prior(lambda p: jloss(jmod, p), jparams, termination_loss=term)
        tl, ts = ttm.fit_to_prior(tloss, tmod.parameters(), termination_loss=term)
        assert ts == int(js)
        np.testing.assert_allclose(tl, float(jl), rtol=1e-3)
        ref = jax.tree.map(np.asarray, jmod.apply(jp, None))
        with torch.no_grad():
            got = tmod()
        for a, b in zip(jax.tree.leaves(ref), got if isinstance(got, tuple) else (got,)):
            assert np.abs(n(b) - a).max() <= 1e-4 * np.abs(a).max()


def test_geometry_init_matches_jax(run):
    """5 steps of the SDF pretrain with JAX's draws (its fold_in keys): the
    SDF and the visibility at 1000 points after them."""
    jt, tt = _jax_copy(run), _port(run, "port_g")
    iters = 5
    draws = []
    for i in list(range(iters)) + [None]:
        rng = jax.random.PRNGKey(0) if i is None else jax.random.fold_in(
            jax.random.PRNGKey(123), i)
        k1, k2 = jax.random.split(jax.random.fold_in(rng, 0))
        draws.append({"fg": (t(jax.random.uniform(k1, (5000, 3))),
                             torch.as_tensor(np.asarray(
                                 jax.random.randint(k2, (5000,), 0, 1))))})
    jt._geometry_init(sdf_iters=iters, verbose=False)
    final = tt._geometry_init(sdf_iters=iters, verbose=False, draws=draws)
    pts = np.random.default_rng(2).uniform(-0.15, 0.15, (1000, 3)).astype(np.float32)

    def fields(mdl):
        f = mdl.fields["fg"]
        return f.sdf(jnp.asarray(pts))[0], f.visibility(jnp.asarray(pts))

    ref = jt.model.apply(jt.params, method=fields)
    field = tt.model.fields["fg"]
    with torch.no_grad():
        got = (field.sdf(t(pts))[0], field.visibility(t(pts)))
    for a, b in zip(ref, got):
        assert np.abs(n(b) - np.asarray(a)).max() <= 1e-4 * np.abs(np.asarray(a)).max()
    assert np.isfinite(final)


def _ellipsoid_sdf(pts):
    """An ellipsoid's signed distance (approximate), numpy float32."""
    q = np.asarray(pts, np.float32) / np.array([0.10, 0.12, 0.08], np.float32)
    return (np.sqrt(np.sum(q * q, -1, keepdims=True)) - 1.0) * np.float32(0.1)


def test_update_geometry_aux_matches_jax(run, monkeypatch):
    """update_geometry_aux with beta 0, then 0.9, on one SDF grid (an
    ellipsoid, computed once in numpy for both packages, so that the
    marching is fed the same values): the proxy mesh, aabb, near/far (the
    cameras of the same parameters) and proxy points."""
    from vidu4d_tpu.models.fields import dyn_nerf as jdn
    from vidu4d_tpu_torch.models.fields import dyn_nerf as tdn

    monkeypatch.setattr(jdn.DynNeRF, "sdf", lambda self, xyz, inst_id=None, alpha=None: (
        jnp.asarray(_ellipsoid_sdf(xyz)), None))
    monkeypatch.setattr(tdn.DynNeRF, "sdf", lambda self, xyz, inst_id=None, alpha=None: (
        torch.as_tensor(_ellipsoid_sdf(n(xyz))), None))
    jt, tt = _jax_copy(run), _port(run, "port_a")
    jt.update_geometry_aux(beta=0.0)
    tt.update_geometry_aux(beta=0.0)
    (jv, jf), (tv, tf) = jt._proxy_mesh, tt._proxy_mesh
    assert len(jv) > 100 and np.array_equal(jf, tf)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    js, ts = jt.states["fg"], tt.states["fg"]
    for f in FieldState._fields:
        np.testing.assert_allclose(n(getattr(ts, f)), np.asarray(getattr(js, f)), atol=1e-6,
                                   err_msg=f)
    # from that state the grid spans an aabb that each package extends with
    # its own rounding (XLA fuses a - s * f): the mesh is the same surface,
    # not the same vertex list
    jt.update_geometry_aux(beta=0.9)
    tt.update_geometry_aux(beta=0.9)
    (jv, _), (tv, _) = jt._proxy_mesh, tt._proxy_mesh
    assert abs(len(tv) - len(jv)) <= 1e-3 * len(jv)
    js, ts = jt.states["fg"], tt.states["fg"]
    np.testing.assert_allclose(n(ts.aabb), np.asarray(js.aabb), atol=1e-6)
    np.testing.assert_allclose(n(ts.near_far), np.asarray(js.near_far), rtol=1e-3)
    assert np.abs(_ellipsoid_sdf(n(ts.proxy_pts))).max() < 1e-3


def test_checkpoints_cross_packages(run, tmp_path):
    """A JAX Stage-2 checkpoint (after a step: a live optax state) read by
    the port bitwise; the port's checkpoint read back bitwise, by the
    port's Stage-3 load_stage2 and by the JAX Stage-3 transfer."""
    from vidu4d_tpu.engine.gs4d_trainer import transfer_stage2_params as jtransfer
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer

    jt = _jax_copy(run)
    batch = jt._example_batch()
    weights = progress_schedule(run.tt._loss_config(), 0)
    jt.params, jt.opt_state, *_ = jt._train_step(jt.params, jt.opt_state, jt.states, batch,
                                                 weights, jax.random.PRNGKey(0))
    jt.current_steps = 1
    jt.save_checkpoint(3)
    tt = _port(run, "port_ck")
    payload = tt.load_checkpoint(os.path.join(jt.save_dir, "ckpt_0003.pth"), reset_steps=False)
    assert (tt.current_steps, tt.current_round) == (1, 3) and "opts" in payload
    got = _flat(convert.dvr_flax_from_state_dict(tt.model.state_dict()))
    ref = _flat(jax.tree.map(np.asarray, jt.params))
    assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)
    for f in FieldState._fields:
        assert np.array_equal(n(getattr(tt.states["fg"], f)),
                              np.asarray(getattr(jt.states["fg"], f))), f
    adam = [s for s in jt.opt_state if hasattr(s, "mu")][0]
    assert tt.optimizer.count == int(adam.count) == 1
    for key in ("mu", "nu"):
        ref = _flat(jax.tree.map(np.asarray, getattr(adam, key)))
        got = _flat(convert.dvr_flax_from_state_dict(getattr(tt.optimizer, key)))
        assert all(np.array_equal(got[k], ref[k]) for k in ref), key

    # the port's own checkpoint: read back, then by both Stage-3 trainers
    tt.save_checkpoint(4)
    path = os.path.join(tt.save_dir, "ckpt_latest.pth")
    back = _port(run, "port_ck2")
    back.load_checkpoint(path, reset_steps=False)
    assert back.current_round == 4
    for (k, a), (_, b) in zip(tt.model.state_dict().items(), back.model.state_dict().items()):
        assert torch.equal(a, b), k
    for key in ("mu", "nu"):
        assert all(torch.equal(getattr(tt.optimizer, key)[k], getattr(back.optimizer, key)[k])
                   for k in tt.optimizer.mu)
    with open(path, "rb") as f:
        raw = pickle.load(f)  # plain numpy dicts: no class of either package
    copied = jtransfer(raw["params"], {"params": {}})["params"]
    assert set(copied) == {"warp", "camera_mlp", "logscale", "intrinsics"}
    s3 = Stage3Trainer({**_opts(run.db, run.logroot, "s3"), "fg_motion": "gs-bob",
                        "pixels_per_image": -1, "imgs_per_gpu": 1, "gs_capacity": 64,
                        "gs_init_samples": 32, "num_rounds": 1}, "cpu")
    keys = s3.load_stage2(path)
    sd = tt.model.state_dict()
    for k in keys:
        src = ("intrinsics." + k[len("intrinsics."):] if k.startswith("intrinsics.")
               else "fields.fg." + k)
        assert torch.equal(s3.deformer.state_dict()[k], sd[src]), k


def test_rollback_and_dispatch_logging(run):
    """iters_per_dispatch groups the log calls as the JAX trainer's chunks
    do (a chunk's last losses and total, not gnorm, when the step count
    crosses a multiple of 100); the rollback, which both trainers share, is
    in tests/test_torch_rounds.py."""
    tt = _port(run, "port_rb")
    calls = []
    tt.opts.update(iters_per_round=3, iters_per_dispatch=2)
    tt.current_steps = 99
    total = tt.train_one_round(log_fn=lambda step, d: calls.append((step, d)))
    assert tt.current_steps == 102 and [c[0] for c in calls] == [101]
    assert {"mask", "rgb", "reg_eikonal", "total"} <= set(calls[0][1])
    assert "gnorm" not in calls[0][1] and isinstance(total, float)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_chunked_render_equals_unchunked(run, device):
    """render_batch in chunks of rays equals the whole frames' render: the
    eval path is per ray, and "vis" is re-normalised by the frames' mean
    transmittance."""
    from vidu4d_tpu_torch.utils.camera_trajectories import construct_batch

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tt = Stage2Trainer(_opts(run.db, run.logroot, f"port_r_{device}"), device)
    tt.update_geometry_aux(beta=0.0)
    batch = construct_batch(0, np.arange(3), 12, None, None, None, tt.device)
    whole = tt.render_batch(batch, 12, chunk=12 * 12)
    parts = tt.render_batch(batch, 12, chunk=25)
    assert whole.keys() == parts.keys() and whole["rgb"].shape == (3, 12, 12, 3)
    for k in whole:
        np.testing.assert_allclose(parts[k], whole[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_cli_stage2_end_to_end(run, tmp_path, monkeypatch):
    """train (mlp_init with 30 SDF steps, the proxy mesh on a 32^3 grid, 2
    rounds of 2 steps at the CLI's full field width), render (ref, rot), export (canonical mesh, motion,
    the warped mesh sequence) and reanimate, with --device cpu on the fake
    database, each from the run's opts.log."""
    import functools

    from vidu4d_tpu_torch import export, reanimate, render, train

    monkeypatch.chdir(tmp_path)
    make_fake_db(tmp_path, num_vids=1, T=8, H=16, W=16)
    monkeypatch.setattr(Stage2Trainer, "mlp_init",
                        functools.partialmethod(Stage2Trainer.mlp_init, sdf_iters=30))
    monkeypatch.setattr(Stage2Trainer, "update_geometry_aux",
                        functools.partialmethod(Stage2Trainer.update_geometry_aux,
                                                grid_size=32))
    tr = train.main(["--seqname", "toy", "--logname", "s2", "--fg_motion", "bob",
                     "--train_res", "16", "--num_rounds", "2", "--iters_per_round", "2",
                     "--imgs_per_gpu", "2", "--pixels_per_image", "4", "--rgb_timefree",
                     "--rgb_dirfree", "--save_freq", "1", "--learning_rate", "3e-5",
                     "--device", "cpu"])
    assert isinstance(tr, Stage2Trainer) and tr.current_steps == 4
    run_dir = os.path.join("logdir", "toy-s2")
    for name in ("opts.log", "ckpt_latest.pth", "000-fg-geo.obj", "001-fg-geo.obj",
                 "001-fg-geo-colors.npy", "001-fg-feat.npy"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    feats = np.load(os.path.join(run_dir, "001-fg-feat.npy"))
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-3)
    flag = [f"--flagfile={run_dir}/opts.log", "--load_suffix", "latest", "--device", "cpu"]
    for view in ("ref", "rot_0_360"):
        out = render.main(flag + ["--render_res", "8", "--viewpoint", view,
                                  "--freeze_id", "0", "--num_frames", "2"])
        assert out["rgb"].shape == (2, 8, 8, 3)
        assert all(np.isfinite(v).all() for v in out.values())
    save_dir = export.main(flag + ["--grid_size", "32", "--export_mesh_stride", "4"])
    assert sorted(os.listdir(save_dir)) == ["canonical-mesh.obj", "fg-00000.obj",
                                            "fg-00004.obj", "motion.json"]
    out = reanimate.main(flag + ["--render_res", "8", "--motion_path",
                                 os.path.join(save_dir, "motion.json")])
    assert out["rgb"].shape == (8, 8, 8, 3) and np.isfinite(out["rgb"]).all()
