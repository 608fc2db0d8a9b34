"""The port's multi-instance training (``--nosingle_inst``: one instance
code per video, ``num_inst = num_vids``) in Stage 2 and Stage 3 against the
JAX package's, on the CPU.

One port Stage2Trainer serves the module: ``--fg_motion bob
--nosingle_inst`` on a 2-video 16 x 16 fake database (2 pairs x 4 pixels,
field depth 2 / width 32, 8 samples), after its `mlp_init` with a short
SDF pretrain (SDF_ITERS steps). The JAX Stage2Trainer of the same options
takes the port's parameters and field states, converted, in place of its
flax init; it still draws its init batch, so both batchers stay in step.

Tolerances:
* `InstEmbedding` / `CondMLP` (float32, codes given, the mean code, the
  instance swap with JAX's draws): within 1e-6 of the largest output;
* the SDF pretrain (float32, 3 steps with JAX's draws over both
  instances): the SDF and the visibility at 500 points, with per-point
  instance ids and with the mean code, within 1e-4 of their largest
  magnitude (as tests/test_torch_stage2_comp.py); the final loss, which
  JAX prints with 6 decimals, within 1e-6 + 1e-4 relative;
* float64 (JAX under ``jax.enable_x64`` with its time code in float64,
  `torch_parity.jax_time_code_in_default_float`): `DynNeRF.query_field`
  within 1e-9 of each output's largest magnitude; one Stage-2 step's loss
  (`DvrModel.loss`) every term within LOSS64 (1e-7) relative, each
  parameter's gradient within GRAD64 (1e-6) of its largest magnitude plus
  FLOOR64 (1e-9) of the largest of any (the JAX model keeps its camera
  prior and matching scores in float32: test_torch_stage2_comp.py);
* the skeleton's per-instance bone lengths (float64): within 1e-12;
* the converters: bitwise; a gs-bob Stage-3 step of the reduced
  configuration (float32, JAX's tile compositor with a budget above the
  densest tile) from that Stage 2: losses within 2e-5 relative, gnorm
  within 1e-3 (tests/test_torch_stage3_step.py).
"""

import copy
import json
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import assert_close, jax_time_code_in_default_float, n, t
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.engine import gs4d_trainer as tgs
from vidu4d_tpu_torch.engine.schedules import progress_schedule
from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
from vidu4d_tpu_torch.models.fields.mlp import CondMLP, flax_default_init_

LR, SDF_ITERS, NUM_VIDS, T = 5e-4, 20, 2, 8
LOSS64, GRAD64, FLOOR64 = 1e-7, 1e-6, 1e-9


def _opts(db, root, logname, **kw):
    return {"dataroot": db, "seqname": "toy", "logname": logname, "logroot": root,
            "data_prefix": "crop", "train_res": 16, "pixels_per_image": 4, "imgs_per_gpu": 2,
            "num_rounds": 2, "iters_per_round": 2, "save_freq": 1, "fg_motion": "bob",
            "field_depth": 2, "field_width": 32, "train_depth_samples": 8,
            "learning_rate": LR, "seed": -1, "single_inst": False, **kw}


def _jax_trainer(opts, params, states):
    """The JAX Stage2Trainer of ``opts`` with ``params`` (a numpy flax tree)
    and ``states`` in place of its flax init."""
    from vidu4d_tpu.engine.trainer import Stage2Trainer as JTrainer
    from vidu4d_tpu.models.fields.dyn_nerf import FieldState as JFieldState

    def init_params(self):
        self._example_batch()
        self.params = jax.tree.map(jnp.asarray, params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_params", init_params)
        jt = JTrainer(opts)
    jt.states = {c: JFieldState(*[jnp.asarray(n(x)) for x in st]) for c, st in states.items()}
    return jt


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_inst")
    db = make_fake_db(root, num_vids=NUM_VIDS, T=T, H=16, W=16)
    logroot = os.path.join(str(root), "logdir")
    tt = Stage2Trainer(_opts(db, logroot, "port"), "cpu")
    tt.mlp_init(sdf_iters=SDF_ITERS, verbose=False)
    params = convert.dvr_flax_from_state_dict(tt.model.state_dict())
    jt = _jax_trainer(_opts(db, logroot, "jax"), params, tt.states)
    return SimpleNamespace(db=db, logroot=logroot, tt=tt, jt=jt, params=params)


@pytest.fixture(autouse=True)
def float64_time_code(monkeypatch):
    jax_time_code_in_default_float(monkeypatch)


def _flat(tree):
    return {"/".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _f64_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _f64(d):
    return {k: (np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32
                else np.asarray(v)) for k, v in d.items()}


def _close_to_max(ref, got, rel, name):
    ref, got = np.asarray(ref), n(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + 1e-30, (name, err)


def _jax_draws(key):
    """JAX DvrModel.reg_losses' draws for ``key`` (`model.py:169-175`), the
    visibility's instance ids over both instances."""
    k_vis, k_gauss, _, k_inst = jax.random.split(key, 4)
    a = lambda x: torch.tensor(np.asarray(x))
    return {"vis": a(jax.random.uniform(k_vis, (512, 3))),
            "inst": a(jax.random.randint(k_inst, (512,), 0, NUM_VIDS)),
            "gauss": a(jax.random.uniform(k_gauss, (2048, 3)))}


@pytest.mark.parametrize("case", ["given", "mean", "swap"])
def test_inst_embedding_and_cond_mlp_match_jax(case):
    """CondMLP(num_inst=3) on (M, 5, C) features: with per-row instance ids,
    with None (the mean instance's code, broadcast over the feature's
    leading axes) and with the instance swap at beta_prob 0.5 from JAX's
    draws (split(rng) -> random ids, uniforms)."""
    from vidu4d_tpu.models.fields.mlp import CondMLP as JCondMLP

    rng = np.random.default_rng(0)
    feat = rng.normal(size=(6, 5, 7)).astype(np.float32)
    inst = np.array([0, 1, 2, 2, 1, 0], np.int32)
    port = CondMLP(7, 3, depth=2, width=16, out_channels=4)
    flax_default_init_(port, torch.Generator().manual_seed(1))
    params = convert.state_dict_to_flax(port.state_dict())
    jmod = JCondMLP(num_inst=3, depth=2, width=16, out_channels=4)
    key = jax.random.PRNGKey(5)
    if case == "given":
        ref = jmod.apply(params, jnp.asarray(feat), jnp.asarray(inst))
        got = port(t(feat), torch.as_tensor(inst))
    elif case == "mean":
        ref = jmod.apply(params, jnp.asarray(feat), None)
        got = port(t(feat), None)
        code = port.inst_embedding.mapping.mean(0)
        with torch.no_grad():
            assert torch.equal(port.inst_embedding.mean_embedding(), code)
    else:
        ref = jmod.apply(params, jnp.asarray(feat), jnp.asarray(inst), beta_prob=0.5, rng=key)
        k1, k2 = jax.random.split(key)
        swap = (torch.tensor(np.asarray(jax.random.randint(k1, (6,), 0, 3))),
                torch.tensor(np.asarray(jax.random.uniform(k2, (6,)))))
        got = port(t(feat), torch.as_tensor(inst), beta_prob=0.5, swap=swap)
        assert not torch.equal(torch.where(swap[1] < 0.5, swap[0], torch.as_tensor(inst)),
                               torch.as_tensor(inst).long())
        # inert without draws or at beta_prob 0, as in JAX
        plain = port(t(feat), torch.as_tensor(inst))
        assert torch.equal(port(t(feat), torch.as_tensor(inst), beta_prob=0.5), plain)
        assert torch.equal(port(t(feat), torch.as_tensor(inst), swap=swap), plain)
    _close_to_max(ref, got.detach(), 1e-6, case)


def test_trainer_has_one_code_per_video(run):
    """--nosingle_inst: num_inst = num_vids (2); every CondMLP of the fields
    carries a (2, 32) instance code, and the converted tree has the JAX
    model's names and shapes."""
    tt, jt = run.tt, run.jt
    assert tt.num_inst == jt.model.num_inst == NUM_VIDS
    sd = tt.model.state_dict()
    for name in ("basefield", "colorfield", "vis_field"):
        assert sd[f"fields.fg.{name}.inst_embedding.mapping"].shape == (NUM_VIDS, 32)
    batch = jt._example_batch()
    config = tt._loss_config()
    shapes = jax.eval_shape(lambda: jt.model.init(
        jax.random.PRNGKey(0), batch, jt.states, config, progress_schedule(config, 0),
        jax.random.PRNGKey(1), method=jt.model.loss))
    shape = lambda tree: {"/".join(getattr(p, "key", str(p)) for p in path): tuple(v.shape)
                          for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shape(shapes) == shape(run.params)


def test_sdf_pretrain_with_instance_draws_matches_jax(run, capsys):
    """3 SDF-pretrain steps from the same parameters with JAX's draws (the
    instance ids over both instances): the SDF and the visibility at 500
    points with per-point ids and with the mean code, and the final loss."""
    jt = copy.copy(run.jt)
    tt = Stage2Trainer(_opts(run.db, run.logroot, "port_g"), "cpu")
    tt.model.load_state_dict(run.tt.model.state_dict())
    tt.states = dict(run.tt.states)
    iters = 3
    draws = []
    for i in list(range(iters)) + [None]:
        rng = jax.random.PRNGKey(0) if i is None else jax.random.fold_in(
            jax.random.PRNGKey(123), i)
        k1, k2 = jax.random.split(jax.random.fold_in(rng, 0))
        inst = np.asarray(jax.random.randint(k2, (5000,), 0, NUM_VIDS))
        assert set(np.unique(inst)) == {0, 1}
        draws.append({"fg": (t(jax.random.uniform(k1, (5000, 3))), torch.tensor(inst))})
    jt._geometry_init(sdf_iters=iters, verbose=True)
    ref_loss = float(capsys.readouterr().out.split("loss=")[1].split()[0])
    got_loss = tt._geometry_init(sdf_iters=iters, verbose=False, draws=draws)
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-4, atol=1e-6)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.15, 0.15, (500, 3)).astype(np.float32)
    ids = rng.integers(0, NUM_VIDS, 500).astype(np.int32)
    field = tt.model.fields["fg"]
    for inst in (ids, None):
        jinst = None if inst is None else jnp.asarray(inst)
        tinst = None if inst is None else torch.as_tensor(inst)
        ref = jt.model.apply(jt.params, method=lambda m: (
            m.fields["fg"].sdf(jnp.asarray(pts), inst_id=jinst)[0],
            m.fields["fg"].visibility(jnp.asarray(pts), jinst)))
        with torch.no_grad():
            got = (field.sdf(t(pts), inst_id=tinst)[0], field.visibility(t(pts), tinst))
        for a, b in zip(ref, got):
            _close_to_max(a, b, 1e-4, f"inst={'mean' if inst is None else 'ids'}")


def _states64(states):
    from vidu4d_tpu.models.fields.dyn_nerf import FieldState as JFieldState

    return ({c: JFieldState(*[jnp.asarray(np.asarray(n(x), np.float64)) for x in st])
             for c, st in states.items()},
            {c: FieldState(*[x.double() for x in st]) for c, st in states.items()})


def test_query_field_matches_jax_float64(run):
    """DynNeRF.query_field of the fg field on a batch of both videos (its
    samples carry each ray's video as the instance id), float64: every
    output of the feature dict and the deltas."""
    jt, tt = run.jt, run.tt
    batch = jt._example_batch()
    assert set(np.unique(np.asarray(batch["dataid"]))) <= {0, 1}
    model = copy.deepcopy(tt.model).double()
    with jax.enable_x64(True):
        jstates, tstates = _states64(tt.states)
        jb = {k: jnp.asarray(v) for k, v in _f64(batch).items()}

        def run_field(m):
            field = m.fields["fg"]
            samples = field.get_samples(m.compute_kinv(jb), jb, jstates["fg"])
            feat, deltas, _ = field.query_field(samples, jstates["fg"], train=True, alpha=0.6)
            return feat, deltas

        ref_feat, ref_deltas = jax.jit(lambda p: jt.model.apply(p, method=run_field))(
            _f64_tree(run.params))
        ref_feat = jax.tree.map(np.asarray, ref_feat)
    tb = {k: torch.as_tensor(v) for k, v in _f64(batch).items()}
    field = model.fields["fg"]
    samples = field.get_samples(model.compute_kinv(tb), tb, tstates["fg"])
    feat, deltas, _ = field.query_field(samples, tstates["fg"], train=True, alpha=0.6)
    assert set(feat) == set(ref_feat)
    for k in ref_feat:
        _close_to_max(ref_feat[k], feat[k].detach(), 1e-9, k)
    _close_to_max(ref_deltas, deltas.detach(), 1e-9, "deltas")


def test_stage2_loss_and_gradients_match_jax_float64(run):
    """One Stage-2 step's loss (DvrModel.loss at step 0, alpha 0.6) with
    JAX's draws over both instances, float64: every weighted term and every
    parameter's gradient, the instance codes' among them."""
    tt, jt = run.tt, run.jt
    config = tt._loss_config()
    weights = progress_schedule(config, 0)
    batch = jt._example_batch()
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        draws = _jax_draws(key)
        jstates, tstates = _states64(tt.states)
        jb = {k: jnp.asarray(v) for k, v in _f64(batch).items()}

        def fn(p):
            ld, _ = jt.model.apply(p, jb, jstates, config, weights, key, method=jt.model.loss)
            return sum(jax.tree.leaves(ld)), ld

        (_, jld), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            _f64_tree(run.params))
        jld = {k: float(v) for k, v in jld.items()}
    assert set(np.unique(n(draws["inst"]))) == {0, 1}
    model = copy.deepcopy(tt.model).double()
    model.zero_grad(set_to_none=True)
    tb = {k: torch.as_tensor(v) for k, v in _f64(batch).items()}
    d64 = {k: (v.double() if v.is_floating_point() else v) for k, v in draws.items()}
    tld, _ = model.loss(tb, tstates, config, weights, d64)
    sum(tld.values()).backward()
    assert set(tld) == set(jld), sorted(set(tld) ^ set(jld))
    for k in jld:
        np.testing.assert_allclose(float(tld[k].detach()), jld[k], rtol=LOSS64, atol=1e-300,
                                   err_msg=k)
    ref = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(convert.dvr_flax_from_state_dict(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in model.named_parameters()}))
    assert ref.keys() == got.keys(), sorted(set(ref) ^ set(got))
    assert float(np.abs(got["params/fields_fg/basefield/inst_embedding/mapping"]).max()) > 0
    floor = FLOOR64 * max(float(np.abs(v).max()) for v in ref.values())
    for k in ref:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= GRAD64 * float(np.abs(ref[k]).max()) + floor, (k, err)


def test_converters_and_checkpoints_round_trip(run, tmp_path):
    """A num_inst = 2 model: state dict -> flax tree -> state dict bitwise;
    the port's checkpoint and the JAX trainer's both load into a fresh
    --nosingle_inst port trainer bitwise, and the JAX Stage-3 transfer
    reads the port's file."""
    from vidu4d_tpu.engine.gs4d_trainer import transfer_stage2_params as jtransfer

    tt, jt = run.tt, copy.copy(run.jt)
    sd = tt.model.state_dict()
    back = convert.dvr_state_dict_from_flax(convert.dvr_flax_from_state_dict(sd))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    tt.save_checkpoint(1)
    jt.save_dir = str(tmp_path)
    jt.save_checkpoint(1)
    for path in (os.path.join(tt.save_dir, "ckpt_latest.pth"),
                 os.path.join(str(tmp_path), "ckpt_latest.pth")):
        fresh = Stage2Trainer(_opts(run.db, run.logroot, "port_ckpt"), "cpu")
        fresh.load_checkpoint(path)
        got = fresh.model.state_dict()
        assert all(torch.equal(got[k], sd[k]) for k in sd), path
        for c in tt.states:
            assert all(torch.equal(a, b) for a, b in zip(fresh.states[c], tt.states[c]))
    with open(os.path.join(tt.save_dir, "ckpt_latest.pth"), "rb") as f:
        raw = pickle.load(f)
    copied = jtransfer(raw["params"], {"params": {}})["params"]
    assert set(copied) == {"warp", "camera_mlp", "logscale", "intrinsics"}


def _s3_opts(db, root, logname, **kw):
    return {"dataroot": db, "seqname": "toy", "logname": logname, "logroot": root,
            "data_prefix": "crop", "train_res": 16, "pixels_per_image": -1,
            "imgs_per_gpu": 1, "fg_motion": "gs-bob", "gs_capacity": 448,
            "gs_init_samples": 400, "sh_degree": 3, "single_inst": False,
            "gs_optim_warp": False, "rgb_loss_only": True, "flow_wt": 0.0, **kw}


def test_stage3_step_from_the_nosingle_inst_stage2_matches_jax(run):
    """gs-bob --nosingle_inst on the 2-video database from the port's
    Stage-2 output (its fg mesh, its checkpoint taken over by
    `load_stage2`; the JAX Stage-2 file too): one step of the reduced
    configuration against the JAX Stage3Trainer with the same deformer
    parameters and surfels: every loss and gnorm."""
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.engine.schedules import progress_schedule as jprogress

    tt2, jt2 = run.tt, copy.copy(run.jt)
    tt2.export_geometry(0)
    tt2.save_checkpoint(1)
    mesh = os.path.join(tt2.save_dir, "000-fg-geo.obj")
    s3 = tgs.Stage3Trainer(_s3_opts(run.db, run.logroot, "s3_port", gs_init_mesh=mesh), "cpu")
    assert s3.deformer.num_inst == NUM_VIDS
    keys = s3.load_stage2(os.path.join(tt2.save_dir, "ckpt_latest.pth"))
    jt2.save_dir = os.path.join(run.logroot, "jax_s2")
    os.makedirs(jt2.save_dir, exist_ok=True)
    jt2.save_checkpoint(1)
    other = tgs.Stage3Trainer(_s3_opts(run.db, run.logroot, "s3_port_j"), "cpu")
    assert other.load_stage2(os.path.join(jt2.save_dir, "ckpt_latest.pth")) == keys
    for k in keys:
        assert torch.equal(other.deformer.state_dict()[k], s3.deformer.state_dict()[k]), k
    params = convert.state_dict_to_flax(s3.deformer.state_dict())

    def init_params(self):
        self._next_batch()
        self.params = jax.tree.map(jnp.asarray, params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_params", init_params)
        jt = JTrainer({**_s3_opts(run.db, run.logroot, "s3_jax", gs_init_mesh=mesh),
                       "raster_impl": "tiles", "raster_budget": 2048,
                       "raster_tile_chunk": 4})
    assert jt.deformer.num_inst == NUM_VIDS
    s3.set_surfels(convert.surfel_state_from_jax(jax.tree.map(np.array, jt.surfels), "cpu"))
    s3.gs_adam = convert.gs_adam_from_jax(jax.tree.map(np.array, jt.gs_adam), "cpu")
    batch = jt._next_batch()
    weights = jprogress({**jt._loss_config(), "reg_eikonal_wt": 0.0}, 1000)
    *_, jm = jt._train_step(jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state, batch,
                            weights)
    tm = s3.train_step({k: torch.tensor(np.asarray(v)) for k, v in batch.items()})
    jm = jax.tree.map(np.asarray, jm)
    assert set(jm) == set(tm)
    assert float(tm["gnorm"]) > 0 and float(tm["rgb"]) > 0
    for k in jm:
        if k in ("alive", "overflow_splats", "truncated_entries"):
            assert int(jm[k]) == int(tm[k]), k
        elif k == "gnorm":
            assert_close(jm[k], tm[k], 0.0, 1e-3, k)
        else:
            assert_close(jm[k], tm[k], 1e-9, 2e-5, k)


def test_render_and_export_of_the_second_video(run):
    """render / export --inst_id 1 of the --nosingle_inst Stage-2 run (video
    v of the fake database has 8 + 2v frames, raw offsets 0, 8, 18):
    renderings_0001/ with one frame per frame of video 1 but the last (a
    second ``render --logdir`` keeps its own ``--inst_id``: the first one's
    trainer wrote ``inst_id`` 0 into opts.json, which overrode it),
    export_0001/ whose motion.json holds video 1's cameras (raw frames
    8..17) and whose mesh sequence is of those frames; the render differs
    from video 0's (its own instance codes)."""
    from vidu4d_tpu_torch import export, render

    tt = run.tt
    offsets = list(tt.frame_info.frame_offset_raw)
    assert offsets == [0, 8, 18]
    tt.save_checkpoint(1)
    flag = ["--device", "cpu", "--logdir", tt.save_dir, "--load_suffix", "latest"]
    outs = {}
    for vid in (0, 1):
        outs[vid] = render.main(flag + ["--inst_id", str(vid), "--render_res", "8",
                                        "--viewpoint", "ref", "--num_frames", "3",
                                        "--freeze_id", "2"])
        assert outs[vid]["rgb"].shape == (3, 8, 8, 3)
        assert os.path.isdir(os.path.join(tt.save_dir, "renderings_%04d" % vid, "ref"))
    assert not np.array_equal(outs[0]["rgb"], outs[1]["rgb"])
    save_dir = export.export({**tt.opts, "load_suffix": "latest", "inst_id": 1,
                              "grid_size": 32, "export_mesh_stride": 4}, "cpu")
    assert save_dir.endswith("export_0001")
    with open(os.path.join(save_dir, "motion.json")) as f:
        motion = json.load(f)
    with torch.no_grad():
        q, _ = tt.model.fields["fg"].camera_mlp(torch.arange(offsets[1], offsets[2]))
    assert_close(n(q), np.asarray(motion["field2cam"]["quat"]), 1e-6)
    assert sorted(f for f in os.listdir(save_dir) if f.startswith("fg-")) == [
        "fg-00008.obj", "fg-00012.obj", "fg-00016.obj"]


def test_skeleton_bone_lengths_per_instance_match_jax():
    """A 2-video quad skeleton: the bone-length MLP's code per video
    (`compute_rel_rest_joints` with ids, and with None: the mean code), the
    rest pose (`mean_vals`, which read no instance id and raised on a
    2-video database before), the articulation at frames of both videos
    and the skeleton prior, float64. The two videos' bone lengths differ."""
    from vidu4d_tpu.data.frame_info import FrameInfo as JFrameInfo
    from vidu4d_tpu.models.fields.skeleton import ArticulationSkelMLP as JArt
    from vidu4d_tpu_torch.models.fields.skeleton import ArticulationSkelMLP

    fi = FrameInfo(frame_offset=(0, T, 2 * T), frame_mapping=tuple(range(2 * T)),
                   frame_offset_raw=(0, T, 2 * T))
    port = ArticulationSkelMLP(fi, skel_type="quad")
    flax_default_init_(port, torch.Generator().manual_seed(0))
    port = port.double()
    with torch.no_grad():
        port.logscale.fill_(0.2)
    fid = np.array([1, 6, 9, 14])

    def outs(m, inst, f):
        return (m.compute_rel_rest_joints(inst_id=inst), m.compute_rel_rest_joints(),
                *m.mean_vals(), *m(f), m.skel_prior_loss())

    jmod = JArt(frame_info=JFrameInfo(*fi), skel_type="quad")
    with jax.enable_x64(True):
        jp = _f64_tree(convert.state_dict_to_flax(port.state_dict()))
        ref = jax.jit(lambda p: jmod.apply(p, method=lambda m: outs(
            m, jnp.asarray([0, 1]), jnp.asarray(fid))))(jp)
        ref = [np.asarray(r) for r in ref]
    with torch.no_grad():
        got = outs(port, torch.tensor([0, 1]), torch.as_tensor(fid))
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        _close_to_max(a, b, 1e-12, f"output {i}")
    per_inst = n(got[0])
    assert per_inst.shape == (2, 25, 3)
    assert np.abs(per_inst[0] - per_inst[1]).max() > 1e-3
