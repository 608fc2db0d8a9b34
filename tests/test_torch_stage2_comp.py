"""The port's Stage 2 with the composed fields and a skeleton, and its
hand-off to a skeleton Stage 3, against the JAX package's, on the CPU.

One port Stage2Trainer serves the module: ``--field_type comp
--fg_motion skel-quad`` on a 16 x 16 fake database (2 pairs x 4 pixels,
field depth 2 / width 32, 8 samples), after its `mlp_init` with a short
SDF pretrain (SDF_ITERS steps). The JAX Stage2Trainer of the same options
takes the port's parameters and field states, converted
(`convert.dvr_flax_from_state_dict`), in place of its flax init; it still
draws its init batch, so both batchers stay in step.

Float64 comparisons (the JAX side under ``jax.enable_x64`` with its time
code in float64, `torch_parity.jax_time_code_in_default_float`, and its
draws made in float64 mode): DvrModel.loss of "comp" (fg skeleton + rigid
bg, depth-sorted) and "bg", and the sampled regularisers of a composed fg
warp (soft deform, with JAX's draws: the points and the frame ids of one
key): each term within LOSS64 (1e-7) relative, each parameter's gradient
within GRAD64 (1e-6) of its largest magnitude plus FLOOR64 (1e-9) of the
largest of any parameter. The JAX model keeps two float32 steps in
float64 mode, its camera prior and its matching scores
(``preferred_element_type``): measured <= 6.6e-9 (reg_cam_prior), <= 9e-8
(the feature field's gradients) and <= 2.7e-10 of the largest gradient;
every other term within 2e-13. The composite's depth sort sees the same
depths; ties keep category order in both packages' stable sorts.

Float32 comparisons (as test_torch_stage2.py / test_torch_stage3_*.py
state them): one Stage2Trainer step: each term within 1e-3 relative, the
total within 1e-4, gnorm within 1e-3, each parameter after the AdamW
update within 2 x its step; one Stage3Trainer step of gs-skel-quad (the
default configuration at 32^2, the JAX tile compositor with a budget above
the densest tile) from the same converted state and a batch with
"joint_so3": every loss within 2e-5 relative, gnorm within 1e-3; the
deformer's articulation cache without and with "joint_so3" and with
"t_articulation" too within 1e-6; motion.json within 1e-6 + 1e-5
relative (float32 outputs; the translations are divided by exp(logscale)).
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
from vidu4d_tpu_torch.data import data_utils
from vidu4d_tpu_torch.engine import gs4d_trainer as tgs
from vidu4d_tpu_torch.engine.model import DvrModel
from vidu4d_tpu_torch.engine.optim import lr_multiplier
from vidu4d_tpu_torch.engine.schedules import progress_schedule
from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params
from vidu4d_tpu_torch.ops.quaternion import quaternion_translation_to_se3

LR, SDF_ITERS, RES3 = 5e-4, 20, 32
LOSS64, GRAD64, FLOOR64 = 1e-7, 1e-6, 1e-9
# the gs-* motions: Stage 3 trains the first seven, rejects the others
GS_MOTIONS = ["gs-bob", "gs-bob-nosoft", "gs-bob-sc", "gs-skel-human", "gs-skel-quad",
              "gs-denseSE3", "gs-rigid", "gs-dense", "gs-nvp", "gs-comp_skel-quad_dense",
              "gs-comp_bob"]


def _opts(db, root, logname, **kw):
    return {"dataroot": db, "seqname": "toy", "logname": logname, "logroot": root,
            "data_prefix": "crop", "train_res": 16, "pixels_per_image": 4, "imgs_per_gpu": 2,
            "num_rounds": 2, "iters_per_round": 2, "save_freq": 1, "field_type": "comp",
            "fg_motion": "skel-quad", "field_depth": 2, "field_width": 32,
            "train_depth_samples": 8, "learning_rate": LR, "seed": -1, **kw}


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
    root = tmp_path_factory.mktemp("s2comp")
    db = make_fake_db(root, num_vids=1, T=8, H=16, W=16)
    logroot = os.path.join(str(root), "logdir")
    # the bg camera prior (rtmat[0]) moved 2 further away than the fg one:
    # mlp_init must not use it (the JAX trainer loads it and never does)
    opts = _opts(db, logroot, "port")
    datasets = data_utils.build_datasets(opts)
    data_info = data_utils.get_data_info(datasets)
    data_info["rtmat"] = data_info["rtmat"].copy()
    data_info["rtmat"][0, :, 2, 3] += 2.0
    tt = Stage2Trainer(opts, "cpu", datasets=datasets, data_info=data_info)
    info = tt.mlp_init(sdf_iters=SDF_ITERS, verbose=False)
    params = convert.dvr_flax_from_state_dict(tt.model.state_dict())
    jt = _jax_trainer(_opts(db, logroot, "jax"), params, tt.states)
    return SimpleNamespace(db=db, root=str(root), logroot=logroot, tt=tt, jt=jt,
                           params=params, info=info)


def _flat(tree):
    return {"/".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree):
    return {"/".join(getattr(p, "key", str(p)) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_draws(key, num_frames):
    """JAX DvrModel.reg_losses' draws for ``key`` (`model.py:172-199`): the
    soft-deform points and frame ids both come from k_soft."""
    k_vis, k_gauss, k_soft, k_inst = jax.random.split(key, 4)
    a = lambda x: torch.tensor(np.asarray(x))
    return {"vis": a(jax.random.uniform(k_vis, (512, 3))),
            "inst": a(jax.random.randint(k_inst, (512,), 0, 1)),
            "gauss": a(jax.random.uniform(k_gauss, (2048, 3))),
            "soft": a(jax.random.uniform(k_soft, (1024, 3))),
            "soft_fid": a(jax.random.randint(k_soft, (1024,), 0, num_frames))}


def _f64_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _f64(d):
    return {k: (np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32
                else np.asarray(v)) for k, v in d.items()}


def _grads_close(jgrads, model, name):
    ref = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(convert.dvr_flax_from_state_dict(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in model.named_parameters()}))
    assert ref.keys() == got.keys(), sorted(set(ref) ^ set(got))
    floor = FLOOR64 * max(float(np.abs(v).max()) for v in ref.values())
    for k in ref:
        assert got[k].dtype == np.float64, k
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= GRAD64 * float(np.abs(ref[k]).max()) + floor, (name, k, err)


def _loss64(jmodel, params, batch, states, config, weights, key, port):
    """Every weighted term and every gradient of their sum, float64, in both
    packages; the port gets the JAX model's draws (float64 ones: JAX draws
    other values in float64 mode)."""
    from vidu4d_tpu.models.fields.dyn_nerf import FieldState as JFieldState

    with jax.enable_x64(True):
        draws = _jax_draws(key, port.frame_info.num_frames_raw)
        jstates = {c: JFieldState(*[jnp.asarray(np.asarray(n(x), np.float64)) for x in st])
                   for c, st in states.items()}
        jb = {k: jnp.asarray(v) for k, v in _f64(batch).items()}

        def fn(p):
            ld, _ = jmodel.apply(p, jb, jstates, config, weights, key, method=jmodel.loss)
            return sum(jax.tree.leaves(ld)), ld

        (jtot, jld), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            _f64_tree(params))
        jld = {k: float(v) for k, v in jld.items()}
    model = copy.deepcopy(port).double()
    model.zero_grad(set_to_none=True)
    tstates = {c: FieldState(*[x.double() for x in st]) for c, st in states.items()}
    tb = {k: torch.as_tensor(v) for k, v in _f64(batch).items()}
    d64 = {k: (v.double() if v.is_floating_point() else v) for k, v in draws.items()}
    tld, _ = model.loss(tb, tstates, config, weights, d64)
    total = sum(tld.values())
    total.backward()
    assert set(tld) == set(jld), sorted(set(tld) ^ set(jld))
    for k in jld:
        np.testing.assert_allclose(float(tld[k].detach()), jld[k], rtol=LOSS64, atol=1e-300,
                                   err_msg=k)
    return jgrads, model, tld


@pytest.fixture(autouse=True)
def float64_time_code(monkeypatch):
    jax_time_code_in_default_float(monkeypatch)


def test_mlp_init_fits_every_field_to_the_fg_prior(run):
    """mlp_init fitted both fields' cameras to the fg camera prior, not to
    the bg one (moved 0.2 away at the init scale): each fit ends within
    1e-3 of the fg prior (the fit stops below 1e-4 and then takes its last
    Adam step), its depth within 0.05 of the fg prior's; each field has its
    own proxy mesh, and the fg one is the one the export writes."""
    tt = run.tt
    assert list(tt.states) == ["fg", "bg"]
    frame_map = np.asarray(tt.frame_info.frame_mapping)
    fg_prior = tt.data_info["rtmat"][1][frame_map].copy()
    fg_prior[:, :3, 3] *= 0.1
    assert np.abs(tt.data_info["rtmat"][0][:, 2, 3] * 0.1 - fg_prior[:, 2, 3]).min() > 0.15
    for cate in ("fg", "bg"):
        rt = n(quaternion_translation_to_se3(*tt.model.fields[cate].camera_vals()))
        assert np.mean((rt - fg_prior) ** 2) <= 1e-3, cate
        assert np.abs(rt[:, 2, 3] - fg_prior[:, 2, 3]).max() < 0.05, cate
    assert set(tt.proxy_meshes) == {"fg", "bg"}
    assert tt._proxy_mesh is tt.proxy_meshes["fg"]


def test_geometry_init_runs_sorted_categories_like_jax(run):
    """3 SDF-pretrain steps from the same parameters with JAX's draws, one
    per category in sorted order (bg, then fg: `fold_in(rng, idx)`): both
    fields' SDFs at 500 points agree within 1e-4 of their largest
    magnitude (float32)."""
    jt = copy.copy(run.jt)
    tt = Stage2Trainer(_opts(run.db, run.logroot, "port_g"), "cpu")
    tt.model.load_state_dict(run.tt.model.state_dict())
    tt.states = dict(run.tt.states)
    iters = 3
    draws = []
    for i in list(range(iters)) + [None]:
        rng = jax.random.PRNGKey(0) if i is None else jax.random.fold_in(
            jax.random.PRNGKey(123), i)
        d = {}
        for idx, cate in enumerate(sorted(tt.states)):
            k1, k2 = jax.random.split(jax.random.fold_in(rng, idx))
            d[cate] = (t(jax.random.uniform(k1, (5000, 3))),
                       torch.tensor(np.asarray(jax.random.randint(k2, (5000,), 0, 1))))
        draws.append(d)
    jt._geometry_init(sdf_iters=iters, verbose=False)
    tt._geometry_init(sdf_iters=iters, verbose=False, draws=draws)
    pts = np.random.default_rng(2).uniform(-0.15, 0.15, (500, 3)).astype(np.float32)
    for cate in ("fg", "bg"):
        ref = np.asarray(jt.model.apply(jt.params, method=lambda m: m.fields[cate].sdf(
            jnp.asarray(pts))[0]))
        with torch.no_grad():
            got = n(tt.model.fields[cate].sdf(t(pts))[0])
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), cate


@pytest.mark.parametrize("field_type", ["comp", "bg"])
def test_param_tree_and_loss_match_jax(run, field_type):
    """DvrModel of ``field_type`` with skel-quad: the converted tree has the
    JAX model's names and shapes (``fields_fg`` / ``fields_bg``, the
    skeleton's articulation), and loss at step 0 (alpha 0.6) with JAX's
    draws matches in float64, every term and every parameter's gradient."""
    tt, jt = run.tt, run.jt
    config = {**tt._loss_config(), "field_type": field_type}
    weights = progress_schedule(config, 0)
    if field_type == "comp":
        port, jmodel, params = tt.model, jt.model, run.params
        states = tt.states
    else:
        port = DvrModel(tt.frame_info, field_type="bg", fg_motion="skel-quad",
                        rtmat_prior=tt.rt_scaled, rgb_timefree=False, train_depth_samples=8,
                        field_depth=2, field_width=32, device="cpu",
                        generator=torch.Generator().manual_seed(5))
        port.fields["bg"].load_state_dict(tt.model.fields["bg"].state_dict())
        port.intrinsics.load_state_dict(tt.model.intrinsics.state_dict())
        jmodel = jt.model.clone(field_type="bg")
        params = convert.dvr_flax_from_state_dict(port.state_dict())
        states = {"bg": tt.states["bg"]}
    assert list(port.fields) == (["fg", "bg"] if field_type == "comp" else ["bg"])
    batch = jt._example_batch()
    key = jax.random.PRNGKey(3)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), batch, jt.states if field_type == "comp" else
        {"bg": jt.states["bg"]}, config, weights, key, method=jmodel.loss))
    assert _shapes(shapes) == _shapes(params)
    jgrads, model, tld = _loss64(jmodel, params, batch, states, config, weights, key, port)
    want = {"mask", "rgb", "depth", "flow", "vis", "reg_eikonal", "reg_visibility",
            "reg_cam_prior"}
    if field_type == "comp":
        want |= {"feature", "feat_reproj", "reg_gauss_mask", "reg_deform_cyc", "reg_delta_skin",
                 "reg_skin_entropy", "reg_gauss_skin", "reg_skel_prior"}
    assert want <= set(tld), sorted(want - set(tld))
    _grads_close(jgrads, model, field_type)


def test_composed_warp_regularisers_match_jax(run):
    """reg_losses of an fg field with the composed warp
    (comp_skel-quad_dense): the soft-deform term from JAX's draws (points
    and frame ids of the one key k_soft), no gauss-skin or skeleton prior
    (a composed warp is not a skinning warp), and the gradients, float64."""
    tt = run.tt
    port = DvrModel(tt.frame_info, field_type="fg", fg_motion="comp_skel-quad_dense",
                    rtmat_prior=tt.rt_scaled, train_depth_samples=8, field_depth=2,
                    field_width=32, device="cpu", generator=torch.Generator().manual_seed(7))
    state = {"fg": tt.states["fg"]}
    jmodel = run.jt.model.clone(field_type="fg", fg_motion="comp_skel-quad_dense")
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        draws = _jax_draws(key, tt.frame_info.num_frames_raw)
        from vidu4d_tpu.models.fields.dyn_nerf import FieldState as JFieldState

        jst = {"fg": JFieldState(*[jnp.asarray(np.asarray(n(x), np.float64))
                                   for x in state["fg"]])}

        def fn(p):
            out = jmodel.apply(p, jst, key, alpha=0.6, method=jmodel.reg_losses)
            return sum(jax.tree.leaves(out)), out

        (_, ref), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(_f64_tree(
            convert.dvr_flax_from_state_dict(port.state_dict())))
    model = copy.deepcopy(port).double()
    got = model.reg_losses({"fg": FieldState(*[x.double() for x in state["fg"]])},
                           {k: (v.double() if v.is_floating_point() else v)
                            for k, v in draws.items()}, alpha=0.6)
    assert set(got) == set(ref) == {"reg_visibility", "reg_soft_deform", "reg_cam_prior"}
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=LOSS64,
                                   err_msg=k)
    sum(got.values()).backward()
    _grads_close(jgrads, model, "composed")
    assert set(port.reg_draws(torch.Generator().manual_seed(0))) == set(draws)


def test_train_step_matches_jax(run):
    """One Stage2Trainer step of comp + skel-quad from the same parameters,
    state and batch with JAX's draws (float32): every loss term, gnorm,
    and the parameters after the AdamW update."""
    jt = copy.copy(run.jt)
    tt = Stage2Trainer(_opts(run.db, run.logroot, "port_s"), "cpu")
    tt.model.load_state_dict(run.tt.model.state_dict())
    tt.states = dict(run.tt.states)
    batch = jt._example_batch()
    weights = progress_schedule(tt._loss_config(), 0)
    params, _, jtot, jld, jgnorm = jt._train_step(
        jt.params, jt.opt_state, jt.states, batch, weights, jax.random.PRNGKey(0))
    m = tt.train_step({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
                      draws=_jax_draws(jax.random.PRNGKey(0), tt.frame_info.num_frames_raw))
    assert set(m) == set(jld) | {"total", "gnorm"}
    assert {"reg_skel_prior", "reg_gauss_skin", "reg_skin_entropy"} <= set(m)
    for k in jld:
        np.testing.assert_allclose(float(m[k]), float(jld[k]), rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["total"]), float(jtot), rtol=1e-4)
    np.testing.assert_allclose(float(m["gnorm"]), float(jgnorm), rtol=1e-3)
    step = LR / 25.0  # OneCycle's first learning rate
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(convert.dvr_flax_from_state_dict(tt.model.state_dict()))
    mult = _flat(convert.dvr_flax_from_state_dict(
        {k: torch.full((1,), lr_multiplier(k)) for k, _ in tt.model.named_parameters()}))
    assert ref.keys() == got.keys()
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= 2 * step * float(mult[k][0]), k


def test_export_writes_joint_so3_like_jax(run, tmp_path):
    """motion.json of the comp + skel-quad model: the fg field's camera,
    t_articulation and the per-frame joint angles (8, 25, 3), as the JAX
    export writes them."""
    from vidu4d_tpu.export import export_motion_params as jexport

    from vidu4d_tpu_torch.export import export_motion_params

    frameid = np.arange(8)
    ref = jexport(run.jt, frameid, str(tmp_path / "jax.json"))
    got = export_motion_params(run.tt, frameid, str(tmp_path / "port.json"))
    with open(tmp_path / "port.json") as f:
        assert json.load(f).keys() == got.keys() == ref.keys()
    assert np.asarray(got["joint_so3"]).shape == (8, 25, 3)
    for a, b in [(ref["field2cam"]["quat"], got["field2cam"]["quat"]),
                 (ref["field2cam"]["trans"], got["field2cam"]["trans"]),
                 (ref["t_articulation"]["qr"], got["t_articulation"]["qr"]),
                 (ref["t_articulation"]["qd"], got["t_articulation"]["qd"]),
                 (ref["joint_so3"], got["joint_so3"])]:
        assert_close(np.asarray(a), np.asarray(b), 1e-6, 1e-5)


def test_stage3_takes_the_skeleton_over_from_stage2(run):
    """The comp + skel-quad checkpoint's fg warp (the 25-bone skeleton's
    articulation and skinning), camera, logscale and intrinsics go into a
    gs-skel-quad deformer bitwise (`load_stage2`), and the JAX Stage-3
    transfer reads the same subtrees from the port's file."""
    from vidu4d_tpu.engine.gs4d_trainer import transfer_stage2_params as jtransfer

    tt = run.tt
    tt.save_checkpoint(1)
    path = os.path.join(tt.save_dir, "ckpt_latest.pth")
    s3 = tgs.Stage3Trainer({**_s3_opts(run.db, run.logroot, "gs-skel-quad", "s3load"),
                            "train_res": 16}, "cpu")
    keys = s3.load_stage2(path)
    assert any(".articulation.so3_head." in k for k in keys)
    assert any(k.startswith("warp.articulation.log_bone_len.") for k in keys)
    sd = tt.model.state_dict()
    for k in keys:
        src = k if k.startswith("intrinsics.") else "fields.fg." + k
        assert torch.equal(s3.deformer.state_dict()[k], sd[src]), k
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert set(raw["params"]["params"]) == {"fields_fg", "fields_bg", "intrinsics"}
    copied = jtransfer(raw["params"], {"params": {}})["params"]
    assert set(copied) == {"warp", "camera_mlp", "logscale", "intrinsics"}
    assert set(copied["warp"]) == {"articulation", "skinning_model", "logibeta"}


def test_cli_comp_skeleton_end_to_end(tmp_path, monkeypatch):
    """The command line with --device cpu on a fake database: train
    --field_type comp --fg_motion skel-quad (mlp_init with 40 SDF steps,
    the proxy meshes on a 32^3 grid, 1 round of 2 steps at the full field
    width) writes both fields' meshes and features; render and export
    (motion.json with joint_so3) from its opts.log; train --fg_motion
    gs-skel-quad from its fg mesh and checkpoint; reanimate of that with
    the Stage-2 motion."""
    import functools

    from vidu4d_tpu_torch import export, reanimate, render, train

    monkeypatch.chdir(tmp_path)
    make_fake_db(tmp_path, num_vids=1, T=8, H=16, W=16)
    monkeypatch.setattr(Stage2Trainer, "mlp_init",
                        functools.partialmethod(Stage2Trainer.mlp_init, sdf_iters=40))
    monkeypatch.setattr(Stage2Trainer, "update_geometry_aux",
                        functools.partialmethod(Stage2Trainer.update_geometry_aux,
                                                grid_size=32))
    common = ["--seqname", "toy", "--train_res", "16", "--num_rounds", "1",
              "--iters_per_round", "2", "--learning_rate", "3e-5", "--device", "cpu"]
    s2 = train.main(common + ["--logname", "s2", "--field_type", "comp", "--fg_motion",
                              "skel-quad", "--imgs_per_gpu", "2", "--pixels_per_image", "4",
                              "--rgb_timefree", "--rgb_dirfree"])
    run_dir = os.path.join("logdir", "toy-s2")
    assert list(s2.states) == ["fg", "bg"] and s2.current_steps == 2
    for cate in ("fg", "bg"):
        for name in (f"000-{cate}-geo.obj", f"000-{cate}-geo-colors.npy",
                     f"000-{cate}-feat.npy"):
            assert os.path.exists(os.path.join(run_dir, name)), name
    flag = [f"--flagfile={run_dir}/opts.log", "--load_suffix", "latest", "--device", "cpu"]
    out = render.main(flag + ["--render_res", "8", "--viewpoint", "ref", "--freeze_id", "0",
                              "--num_frames", "2"])
    assert out["rgb"].shape == (2, 8, 8, 3) and {"mask_fg", "mask_bg"} <= set(out)
    assert all(np.isfinite(v).all() for v in out.values())
    save_dir = export.main(flag + ["--grid_size", "32", "--export_mesh_stride", "4"])
    with open(os.path.join(save_dir, "motion.json")) as f:
        motion = json.load(f)
    assert np.asarray(motion["joint_so3"]).shape == (8, 25, 3)
    s3 = train.main(common + ["--logname", "s3", "--fg_motion", "gs-skel-quad",
                              "--imgs_per_gpu", "1", "--pixels_per_image", "-1",
                              "--gs_capacity", "2048",
                              "--gs_init_mesh", os.path.join(run_dir, "000-fg-geo.obj"),
                              "--load_path", os.path.join(run_dir, "ckpt_latest.pth")])
    assert s3.current_steps == 2 and int(s3.surfels.num_alive()) == 2048
    out = reanimate.main(["--flagfile=logdir/toy-s3/opts.log", "--load_suffix", "latest",
                          "--device", "cpu", "--render_res", "8", "--motion_path",
                          os.path.join(save_dir, "motion.json")])
    assert out["rendered"].shape == (8, 8, 8, 3) and np.isfinite(out["rendered"]).all()


def _s3_opts(db, root, motion, logname):
    return {"dataroot": db, "seqname": "toy", "logname": logname, "logroot": root,
            "data_prefix": "crop", "train_res": RES3, "pixels_per_image": -1,
            "imgs_per_gpu": 1, "fg_motion": motion, "gs_capacity": 448,
            "gs_init_samples": 400, "sh_degree": 3, "feat_reproj_px": 256}


@pytest.fixture(scope="module")
def stage3(tmp_path_factory):
    """A 32^2 database, the port's gs-skel-quad Stage3Trainer and the JAX
    one with the port's deformer parameters in place of its flax init."""
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer

    root = tmp_path_factory.mktemp("s3skel")
    db = make_fake_db(root, num_vids=1, T=8, H=RES3, W=RES3)
    logroot = os.path.join(str(root), "logdir")
    tt = tgs.Stage3Trainer(_s3_opts(db, logroot, "gs-skel-quad", "port"), "cpu")
    # pixel-true intrinsics so the cloud renders (as bench.py does)
    prior = np.tile(np.array([1.2 * RES3, 1.2 * RES3, RES3 / 2, RES3 / 2], np.float32), (8, 1))
    init_intrinsics_base_params(tt.deformer.intrinsics, prior, tt.frame_info)
    params = convert.state_dict_to_flax(tt.deformer.state_dict())

    def init_params(self):
        self._next_batch()
        self.params = jax.tree.map(jnp.asarray, params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_params", init_params)
        jt = JTrainer({**_s3_opts(db, logroot, "gs-skel-quad", "jax"), "raster_impl": "tiles",
                       "raster_budget": 2048, "raster_tile_chunk": 4})
    # registration features, so the feature reprojection runs
    from vidu4d_tpu.models.gaussian import surfels as jsf
    from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init

    rng = np.random.default_rng(7)
    pts = np.asarray(jt.surfels.params.xyz)[:400]
    feats = rng.normal(size=(400, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    jt.surfels = jsf.init_from_points(
        jnp.asarray(pts), jnp.asarray(rng.uniform(size=(400, 3)), jnp.float32), 448,
        sh_degree=3, key=jax.random.PRNGKey(0), regist_feat=jnp.asarray(feats))
    jt.gs_adam = gs_adam_init(jt.surfels.params)
    tt.set_surfels(convert.surfel_state_from_jax(jax.tree.map(np.array, jt.surfels), "cpu"))
    tt.gs_adam = convert.gs_adam_from_jax(jax.tree.map(np.array, jt.gs_adam), "cpu")
    return SimpleNamespace(db=db, logroot=logroot, tt=tt, jt=jt, params=params)


def _joint_batch(jt):
    batch = jt._next_batch()
    so3 = np.random.default_rng(11).normal(size=(batch["frameid"].shape[0], 25, 3)) * 0.2
    return batch, so3.astype(np.float32)


def test_stage3_articulation_overrides_match_jax(stage3):
    """GaussianDeformer.get_samples of gs-skel-quad: the articulation cache
    without "joint_so3", with it (the skeleton driven by the given joint
    angles, the rest pose the mean's) and with "t_articulation" as well
    (which wins, as in JAX)."""
    jt, tt = stage3.jt, stage3.tt
    batch, so3 = _joint_batch(jt)
    t_art = np.random.default_rng(12).normal(size=(so3.shape[0], 25, 2, 4)).astype(np.float32)
    variants = [{}, {"joint_so3": so3}, {"joint_so3": so3, "t_articulation": t_art}]
    for extra in variants:
        jb = {**batch, **{k: jnp.asarray(v) for k, v in extra.items()}}
        ref = jax.jit(lambda p: jt.deformer.apply(p, method=lambda m: (
            m.get_samples(jb)["t_articulation"], m.get_samples(jb)["rest_articulation"])))(
            jt.params)
        with torch.no_grad():
            s = tt.deformer.get_samples({k: torch.as_tensor(np.asarray(v))
                                         for k, v in jb.items()})
        for a, b in zip(jax.tree.leaves(ref), [*s["t_articulation"], *s["rest_articulation"]]):
            assert_close(a, b, 1e-6, name=str(sorted(extra)))


def test_stage3_skeleton_step_with_joint_so3_matches_jax(stage3):
    """One step of gs-skel-quad (default configuration) with a "joint_so3"
    batch from the same state: every loss term and gnorm."""
    from vidu4d_tpu.engine.schedules import progress_schedule as jprogress

    jt, tt = stage3.jt, stage3.tt
    batch, so3 = _joint_batch(jt)
    batch = {**batch, "joint_so3": jnp.asarray(so3)}
    weights = jprogress({**jt._loss_config(), "reg_eikonal_wt": 0.0}, 1000)
    *_, jm = jt._train_step(jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state, batch,
                            weights)
    tm = tt.train_step({k: torch.tensor(np.asarray(v)) for k, v in batch.items()})
    jm = jax.tree.map(np.asarray, jm)
    assert set(jm) == set(tm)
    assert {"reg_skin_entropy", "reg_delta_skin", "flow", "feat_reproj"} <= set(tm)
    for k in jm:
        if k in ("alive", "overflow_splats", "truncated_entries"):
            assert int(jm[k]) == int(tm[k]), k
        elif k == "gnorm":
            assert_close(jm[k], tm[k], 0.0, 1e-3, k)
        else:
            assert_close(jm[k], tm[k], 1e-9, 2e-5, k)


def test_stage3_accepts_the_motions_jax_accepts(stage3):
    """Of the gs-* motions, the port's Stage3Trainer builds exactly those
    whose JAX deformer builds (its init runs the warp's SE(3) form); for
    the others both raise NotImplementedError with the same message. A
    warp without bones trains without the skin terms."""
    from vidu4d_tpu.models.gaussian.deformable import GaussianDeformer as JDeformer
    from vidu4d_tpu.models.gaussian import surfels as jsf

    jt = stage3.jt
    batch = jt._next_batch()
    xyz, rot = jt.surfels.params.xyz, jsf.get_rotation(jt.surfels.params)

    def jax_builds(motion):
        mod = JDeformer(frame_info=jt.frame_info, fg_motion=motion[3:])

        def fwd(m):
            s = m.get_samples(batch)
            xyz_cam, _, _ = m.warp_surfels(xyz, rot, s)
            return m.cycle_loss(xyz_cam, xyz, s)
        try:
            jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), method=fwd))
            return None
        except NotImplementedError as e:
            return str(e)

    accepted = []
    for motion in GS_MOTIONS:
        want = jax_builds(motion)
        opts = _s3_opts(stage3.db, stage3.logroot, motion, "accept")
        if want is None:
            tr = tgs.Stage3Trainer(opts, "cpu")
            accepted.append(motion)
            if motion in ("gs-denseSE3", "gs-rigid"):
                m = tr.train_step()
                assert "reg_skin_entropy" not in m and np.isfinite(float(m["total"]))
        else:
            with pytest.raises(NotImplementedError) as err:
                tgs.Stage3Trainer(opts, "cpu")
            assert str(err.value) == want
    assert accepted == GS_MOTIONS[:7]
