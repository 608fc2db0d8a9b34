"""The port's Stage-3 command line against the JAX package's, on the CPU:
mesh surfel init, the Stage-2 transfer, a jax-free reader of JAX
checkpoints, the reanimation override of get_samples, and the render /
export / reanimate CLI functions on one JAX checkpoint.

One JAX Stage3Trainer (16x16, capacity 256, 160 surfels on a small
ellipsoid mesh, raster_impl="tiles" with a per-tile budget above the
densest tile, so it composites every entry as the port's tile compositor
does) serves the module: it takes over a Stage-2-layout checkpoint
(jittered copies of its own warp / camera / intrinsics, a real FieldState
and an optax adamw state), trains 1 step and writes its checkpoint, which
every port trainer here loads. Its step compiles once.

Tolerances: mesh sampling, colours and features are the same numpy draws
and einsums (1e-6); scales come from the 3-NN distances, summed in another
order (1e-6 relative: 2 ulps of the log-scales); loaded and transferred tensors are
bitwise; renders use test_torch_rasterize.py's bounds (colour, alpha,
depth, normal atol 5e-4 / rtol 1e-3; median depth on >= 99.5% of pixels);
motion.json 1e-6 (float32 MLP outputs of two libraries); the warped OBJ
vertices 1e-5 (the warp's blend sums in another order).
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import assert_close, ellipsoid_mesh, n
from vidu4d_tpu_torch import config, convert
from vidu4d_tpu_torch.engine import gs4d_trainer as tgs
from vidu4d_tpu_torch.models.gaussian.surfels import SurfelParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, CAP, N_INIT, T = 16, 256, 160, 8
VIEWPOINTS = ["ref", "rot_0_90", "bev_30", "refrot_0_360", "novel_0_90"]


def _opts(run, logname):
    """The port's options: the JAX run's, on the kernel path."""
    return {**run["opts"], "logname": logname, "raster_impl": ""}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX trainer on its mesh, after the Stage-2 transfer and 1 step,
    its checkpoint written; its initial and post-transfer parameters."""
    import optax

    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.models.fields.dyn_nerf import FieldState
    from vidu4d_tpu.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu.ops.marching import save_obj

    tmp = tmp_path_factory.mktemp("cli")
    db = make_fake_db(tmp, num_vids=1, T=T, H=RES, W=RES)
    s2 = tmp / "logdir" / "toy-s2"
    verts, faces = ellipsoid_mesh((0.10, 0.12, 0.07), 10, 16)
    mesh = str(s2 / "000-fg-geo.obj")
    save_obj(mesh, verts, faces)
    rng = np.random.default_rng(3)
    np.save(s2 / "000-fg-geo-colors.npy", rng.uniform(size=(len(verts), 3)).astype(np.float32))
    np.save(s2 / "000-fg-feat.npy", rng.normal(size=(len(verts), 16)).astype(np.float32))
    opts = {"dataroot": db, "seqname": "toy", "logname": "jax",
            "logroot": str(tmp / "logdir"), "data_prefix": "crop", "train_res": RES,
            "pixels_per_image": -1, "imgs_per_gpu": 1, "fg_motion": "gs-bob",
            "gs_capacity": CAP, "gs_init_samples": N_INIT, "gs_init_mesh": mesh,
            "sh_degree": 1, "num_rounds": 1, "iters_per_round": 1, "save_freq": 1,
            "densify_from_iter": 1000, "outlier_filtering_interval": 1000,
            "raster_impl": "tiles", "raster_budget": CAP, "raster_tile_chunk": 4,
            "feat_reproj_px": 64}
    jt = JTrainer(opts)
    init = jax.tree.map(np.array, jt.params)

    # a Stage-2 checkpoint: jittered warp / camera / intrinsics, the camera
    # at the identity pose 0.38 in front, the pixel-true intrinsics, and
    # Stage-2-only leaves, states and optimiser state
    p = init["params"]
    jitter = lambda tree: jax.tree.map(
        lambda a: (a + 0.01 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    cam = jitter(p["camera_mlp"])
    for head, bias in (("trans_head", [0.0, 0.0, 0.38]), ("quat_head", [1.0, 0, 0, 0])):
        cam[head]["Dense_0"]["kernel"][:] = 0.0
        cam[head]["Dense_0"]["bias"][:] = bias
    prior = np.tile(np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32), (T, 1))
    intr = jax.tree.map(np.array, init_intrinsics_base_params(
        {"params": jitter(p["intrinsics"])}, prior, jt.frame_info)["params"])
    s2_params = {"params": {
        "fields_fg": {"warp": jitter(p["warp"]), "camera_mlp": cam,
                      "logscale": np.array([np.log(0.8)], np.float32),
                      "logibeta": np.zeros(1, np.float32),
                      "sdf_head": {"kernel": np.zeros((8, 1), np.float32),
                                   "bias": np.zeros(1, np.float32)}},
        "intrinsics": intr}}
    payload = {"current_steps": 400, "current_round": 20, "params": s2_params,
               "states": {"fg": jax.tree.map(np.asarray, FieldState.initial(T))},
               "opt_state": jax.tree.map(np.asarray, optax.adamw(1e-3).init(s2_params)),
               "opts": {"fg_motion": "bob"}}
    s2_ckpt = str(s2 / "ckpt_latest.pth")
    with open(s2_ckpt, "wb") as f:
        pickle.dump(payload, f)
    jt.load_stage2(s2_ckpt)
    after_s2 = jax.tree.map(np.array, jt.params)
    jt.train()
    return {"jt": jt, "opts": opts, "init": init, "after_s2": after_s2, "tmp": tmp,
            "s2_ckpt": s2_ckpt, "mesh": mesh, "ckpt": os.path.join(jt.save_dir,
                                                                   "ckpt_latest.pth")}


@pytest.fixture(scope="module")
def port_opts(run):
    """Options of a port run directory holding a copy of the JAX checkpoint,
    with the render / export flags at their defaults."""
    opts = {**_opts(run, "port"), **{k: d for k, (_, d) in config.RENDER_FLAGS.items()},
            **{k: d for k, (_, d) in config.EXPORT_FLAGS.items()}, "render_res": RES,
            "load_suffix": "latest", "export_mesh_stride": 3}
    d = os.path.join(opts["logroot"], "toy-port")
    os.makedirs(d, exist_ok=True)
    shutil.copy(run["ckpt"], os.path.join(d, "ckpt_latest.pth"))
    return opts


def _jax_opts(port_opts, **kw):
    """The same options for the JAX CLI functions, in the JAX run's directory."""
    return {**port_opts, "logname": "jax", **kw}


def test_init_surfels_from_mesh_matches_jax(run):
    from vidu4d_tpu.engine.gs4d_trainer import init_surfels_from_mesh as jinit

    feat = run["mesh"].replace("-geo.obj", "-feat.npy")
    ref = jax.tree.map(np.asarray, jinit(run["mesh"], feat, CAP, n_samples=N_INIT,
                                         sh_degree=1))
    got = tgs.init_surfels_from_mesh(run["mesh"], feat, CAP, N_INIT, 1,
                                     torch.Generator().manual_seed(0), "cpu")
    assert np.array_equal(ref.alive, n(got.alive)) and int(n(got.alive).sum()) == N_INIT
    for f in SurfelParams._fields:
        if f != "rotation":
            assert_close(getattr(ref.params, f), getattr(got.params, f), 1e-6, 1e-6, f)
    assert n(got.params.regist_feat).shape == (CAP, 16)
    norms = np.linalg.norm(n(got.params.regist_feat)[:N_INIT], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)
    rot = n(got.params.rotation)
    assert rot.shape == (CAP, 4) and (rot[N_INIT:] == [1, 0, 0, 0]).all()
    unit = rot[:N_INIT] / np.linalg.norm(rot[:N_INIT], axis=-1, keepdims=True)
    np.testing.assert_allclose(np.linalg.norm(unit, axis=-1), 1.0, atol=1e-6)


def test_missing_mesh_raises_and_load_path_is_accepted(run):
    """A gs_init_mesh that does not exist raises (the JAX trainer trains
    from a random cloud instead); gs_init_mesh and load_path no longer
    raise NotImplementedError."""
    with pytest.raises(FileNotFoundError):
        tgs.Stage3Trainer({**_opts(run, "port_missing"), "gs_init_mesh": "nope-geo.obj"},
                          "cpu")
    tt = tgs.Stage3Trainer({**_opts(run, "port_ok"), "load_path": run["s2_ckpt"]}, "cpu")
    assert int(tt.surfels.alive.sum()) == N_INIT


def test_state_dict_to_flax_round_trips_the_jax_deformer(run):
    back = convert.state_dict_to_flax(convert.flax_to_state_dict(run["init"]))
    assert jax.tree.structure(back) == jax.tree.structure(run["init"])
    for a, b in zip(jax.tree.leaves(run["init"]), jax.tree.leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_load_stage2_matches_jax(run):
    """From the JAX trainer's initial parameters, load_stage2 gives the
    deformer JAX's post-transfer parameters, in place (the warp AdamW keeps
    its tensors); the Stage-2-only leaves are not taken."""
    tt = tgs.Stage3Trainer(_opts(run, "port_s2"), "cpu")
    convert.load_flax_params_(tt.deformer, run["init"])
    before = {k: v for k, v in tt.deformer.named_parameters()}
    keys = tt.load_stage2(run["s2_ckpt"])
    want = convert.flax_to_state_dict(run["after_s2"])
    got = tt.deformer.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert {k.split(".")[0] for k in keys} == {"warp", "camera_mlp", "logscale", "intrinsics"}
    assert all(tt.warp_opt.params[k] is p for k, p in before.items())


def test_checkpoints_load_without_jax(run, port_opts, tmp_path):
    """In a fresh process where jax, jaxlib, flax, optax and vidu4d_tpu
    cannot be imported: the Stage-2 payload (FieldState and optax states
    kept inert) and the JAX Stage-3 checkpoint load, through load_stage2
    and load_checkpoint; the loaded state equals the JAX payload's."""
    opts_path = tmp_path / "opts.json"
    opts_path.write_text(json.dumps({**port_opts, "logname": "port_nojax"}))
    out = tmp_path / "loaded.npz"
    code = f"""
import json, sys
for m in ("jax", "jaxlib", "flax", "optax", "vidu4d_tpu"):
    sys.modules[m] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
s2 = convert.load_jax_checkpoint({run["s2_ckpt"]!r})
fs = s2["states"]["fg"]
assert isinstance(fs, convert.JaxObject) and type(fs).__name__ == "FieldState", fs
assert type(fs).__module__ == "vidu4d_tpu.models.fields.dyn_nerf" and len(fs.args) == 3
names = {{type(s).__name__ for s in s2["opt_state"] if isinstance(s, convert.JaxObject)}}
assert "ScaleByAdamState" in names, names
tt = Stage3Trainer(json.load(open({str(opts_path)!r})), "cpu")
tt.load_stage2({run["s2_ckpt"]!r})
payload = tt.load_checkpoint({run["ckpt"]!r}, reset_steps=False)
assert type(payload["surfels"]).__name__ == "SurfelState"
arrays = {{"d." + k: v.numpy() for k, v in tt.deformer.state_dict().items()}}
s, a = tt.surfels, tt.gs_adam
for i, x in enumerate((*s.params, *s[1:], *a.mu, *a.nu)):
    arrays[f"s.{{i}}"] = x.detach().numpy()
arrays["counts"] = np.array([a.count, tt.current_steps, tt.current_round])
np.savez({str(out)!r}, **arrays)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
       "vidu4d_tpu") and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]
    with open(run["ckpt"], "rb") as f:
        ref = pickle.load(f)
    got = np.load(out)
    want = convert.flax_to_state_dict(ref["params"])
    for k, v in want.items():
        assert np.array_equal(got["d." + k], n(v)), k
    s, a = ref["surfels"], ref["gs_adam"]
    for i, x in enumerate((*s.params, *s[1:], *a.mu, *a.nu)):
        assert np.array_equal(got[f"s.{i}"], np.asarray(x)), i
    assert list(got["counts"]) == [int(a.count), ref["current_steps"], ref["current_round"]]


def test_get_samples_t_articulation_override_matches_jax(run):
    jt = run["jt"]
    d = tgs.GaussianDeformer(jt.frame_info, "bob", device="cpu")
    convert.load_flax_params_(d, jax.tree.map(np.array, jt.params))
    batch = {k: np.asarray(v) for k, v in jt._next_batch().items()}
    m = batch["frameid"].shape[0]
    rng = np.random.default_rng(4)
    qr = rng.normal(size=(m, 25, 4)).astype(np.float32)
    qr /= np.linalg.norm(qr, axis=-1, keepdims=True)
    art = np.stack([qr, 0.01 * rng.normal(size=(m, 25, 4)).astype(np.float32)], axis=-2)
    batch["t_articulation"] = art
    js = jt.deformer.apply(jt.params, batch, method=jt.deformer.get_samples)
    with torch.no_grad():
        ts = d.get_samples({k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("t_articulation", "rest_articulation", "field2cam"):
        for i in range(2):
            assert_close(js[k][i], ts[k][i], 1e-6, 1e-6, f"{k}[{i}]")
    assert np.array_equal(n(ts["t_articulation"][1]), art[..., 1, :])
    xyz = np.asarray(jt.surfels.params.xyz)[:N_INIT]
    rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (N_INIT, 1))
    jc = jt.deformer.apply(jt.params, xyz, rot, js, method=jt.deformer.warp_surfels)[0]
    with torch.no_grad():
        tc = d.warp_surfels(torch.as_tensor(xyz), torch.as_tensor(rot), ts)[0]
    assert_close(jc, tc, 1e-5, 1e-5, "xyz_cam")
    # a bag of bones has no joints: a batch "joint_so3" is ignored, as in JAX
    with_joints = batch | {"joint_so3": rng.normal(size=(m, 25, 3)).astype(np.float32)}
    js2 = jt.deformer.apply(jt.params, with_joints, method=jt.deformer.get_samples)
    with torch.no_grad():
        ts2 = d.get_samples({k: torch.as_tensor(v) for k, v in with_joints.items()})
    for k in ("t_articulation", "rest_articulation"):
        for i in range(2):
            assert torch.equal(ts2[k][i], ts[k][i]), k
            assert_close(js2[k][i], ts2[k][i], 1e-6, 1e-6, f"joint_so3 {k}[{i}]")


@pytest.fixture(scope="module")
def port_trainer(port_opts):
    from vidu4d_tpu_torch.render import build_trainer

    return build_trainer(port_opts, "cpu")


@pytest.mark.parametrize("viewpoint", VIEWPOINTS)
def test_construct_batch_from_opts_matches_jax(run, port_opts, port_trainer, viewpoint):
    from vidu4d_tpu.render import construct_batch_from_opts as jbatch
    from vidu4d_tpu_torch.render import construct_batch_from_opts as tbatch

    jb = jbatch(_jax_opts(port_opts, viewpoint=viewpoint), run["jt"])
    tb = tbatch({**port_opts, "viewpoint": viewpoint}, port_trainer)
    assert set(jb) == set(tb)
    for k in jb:
        assert_close(np.asarray(jb[k]), tb[k], 1e-5, 1e-5, k)


def _patched_jax_cli(monkeypatch, run):
    """The JAX CLI functions on the module's trainer (its state is its
    checkpoint's) instead of a new one."""
    import vidu4d_tpu.render as jrender

    monkeypatch.setattr(jrender, "build_trainer", lambda opts: run["jt"])


def _assert_renders_close(jout, tout):
    assert set(jout) == set(tout)
    for k in ("rendered", "mask", "depth", "normal"):
        assert jout[k].shape == tout[k].shape, k
        assert_close(jout[k], tout[k], 5e-4, 1e-3, k)
    assert (tout["mask"] > 0.01).mean() > 0.05  # the cloud is in view
    ok = np.isclose(tout["median_depth"], jout["median_depth"], atol=5e-4, rtol=1e-3)
    assert ok.mean() >= 0.995, ok.mean()


@pytest.mark.parametrize("viewpoint", ["ref", "rot_0_90"])
def test_render_matches_jax(run, port_opts, monkeypatch, viewpoint):
    from vidu4d_tpu.render import render as jrender
    from vidu4d_tpu_torch.render import render as trender

    _patched_jax_cli(monkeypatch, run)
    jout = jrender(_jax_opts(port_opts, viewpoint=viewpoint))
    tout = trender({**port_opts, "viewpoint": viewpoint}, "cpu")
    assert tout["rendered"].shape == (T - 1, RES, RES, 3)
    _assert_renders_close(jout, tout)
    saved = os.path.join(port_opts["logroot"], "toy-port", "renderings_0000", viewpoint)
    assert np.array_equal(np.load(os.path.join(saved, "rendered.npy")), tout["rendered"])


@pytest.fixture(scope="module")
def exported(run, port_opts):
    """Both packages' export of the checkpoint: their export directories."""
    import vidu4d_tpu.render as jrender_mod
    from vidu4d_tpu.export import export as jexport
    from vidu4d_tpu_torch.export import export as texport

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender_mod, "build_trainer", lambda opts: run["jt"])
        jexport(_jax_opts(port_opts))
    return os.path.join(run["jt"].save_dir, "export_0000"), texport(port_opts, "cpu")


def test_export_matches_jax(exported):
    from vidu4d_tpu.ops.marching import load_obj

    jdir, tdir = exported
    jm, tm = (json.load(open(os.path.join(d, "motion.json"))) for d in (jdir, tdir))
    assert set(jm) == set(tm) == {"field2cam", "t_articulation"}
    for group in jm:
        for k in jm[group]:
            assert np.shape(jm[group][k]) == np.shape(tm[group][k]), (group, k)
            assert_close(np.asarray(jm[group][k]), np.asarray(tm[group][k]), 1e-6, 1e-6,
                         f"{group}.{k}")
    objs = sorted(f for f in os.listdir(jdir) if f.endswith(".obj"))
    assert objs == sorted(f for f in os.listdir(tdir) if f.endswith(".obj"))
    assert objs == ["fg-%05d.obj" % i for i in range(0, T, 3)]
    for f in objs:
        (jv, jf), (tv, tf) = load_obj(os.path.join(jdir, f)), load_obj(os.path.join(tdir, f))
        assert jv.shape == tv.shape == (N_INIT, 3) and jf.size == tf.size == 0
        assert_close(jv, tv, 1e-5, 1e-5, f)
    ply = [open(os.path.join(d, "canonical-surfels.ply"), "rb").read() for d in (jdir, tdir)]
    assert ply[0] == ply[1]


def test_reanimate_matches_jax(run, port_opts, exported, monkeypatch):
    """Both packages re-drive the model with the JAX export's motion."""
    from vidu4d_tpu.reanimate import reanimate as jreanimate
    from vidu4d_tpu_torch.reanimate import reanimate as treanimate

    motion = os.path.join(exported[0], "motion.json")
    _patched_jax_cli(monkeypatch, run)
    jreanimate(_jax_opts(port_opts, motion_path=motion))
    jdir = os.path.join(run["jt"].save_dir, "reanimation")
    jout = {k[:-4]: np.load(os.path.join(jdir, k)) for k in os.listdir(jdir)
            if k.endswith(".npy")}
    tout = treanimate({**port_opts, "motion_path": motion}, "cpu")
    assert tout["rendered"].shape == (T, RES, RES, 3)
    _assert_renders_close(jout, tout)


def test_cli_entry_points_end_to_end(run, tmp_path, monkeypatch):
    """python -m vidu4d_tpu_torch.train --device cpu from a Stage-2 output
    (a new process; the database is read from the working directory; the
    trainer's 200k mesh samples cut to the capacity), then render / export
    / reanimate through their main() from its opts.log (render also from
    its opts.json, with --logdir)."""
    from vidu4d_tpu_torch import export as texport
    from vidu4d_tpu_torch import reanimate as treanimate
    from vidu4d_tpu_torch import render as trender

    logroot = str(tmp_path / "logdir")
    argv = ["--device", "cpu", "--seqname", "toy", "--logname", "cli", "--logroot", logroot,
            "--fg_motion", "gs-bob", "--gs_init_mesh", run["mesh"],
            "--load_path", run["s2_ckpt"], "--gs_capacity", str(CAP), "--train_res", str(RES),
            "--imgs_per_gpu", "1", "--pixels_per_image", "-1", "--num_rounds", "1",
            "--iters_per_round", "1", "--save_freq", "1", "--sh_degree", "1"]
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-m", "vidu4d_tpu_torch.train", *argv],
                         capture_output=True, text=True, timeout=600, cwd=str(run["tmp"]),
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Round 000:" in res.stdout and f"alive={CAP}" in res.stdout
    run_dir = os.path.join(logroot, "toy-cli")
    assert {"opts.log", "opts.json", "ckpt_0001.pth", "ckpt_latest.pth",
            "point_cloud_0001.ply"} <= set(os.listdir(run_dir))
    opts_log = os.path.join(run_dir, "opts.log")
    saved = config.parse_flags([f"--flagfile={opts_log}"])
    assert (saved["gs_init_mesh"], saved["load_path"], saved["train_res"]) == (
        run["mesh"], run["s2_ckpt"], RES)

    monkeypatch.chdir(run["tmp"])
    load = ["--device", "cpu", f"--flagfile={opts_log}", "--load_suffix", "latest"]
    out = trender.main(load + ["--render_res", str(RES), "--viewpoint", "ref"])
    assert out["rendered"].shape == (T - 1, RES, RES, 3) and np.isfinite(out["rendered"]).all()
    # --logdir: the run's opts.json in place of the flagfile
    out2 = trender.main(["--device", "cpu", "--logdir", run_dir, "--load_suffix", "latest",
                         "--render_res", str(RES)])
    assert np.array_equal(out2["rendered"], out["rendered"])
    exp_dir = texport.main(load + ["--export_mesh_stride", "4"])
    assert len(json.load(open(os.path.join(exp_dir, "motion.json")))["field2cam"]["quat"]) == T
    out = treanimate.main(load + ["--render_res", str(RES), "--motion_path",
                                  os.path.join(exp_dir, "motion.json")])
    assert out["rendered"].shape == (T, RES, RES, 3) and np.isfinite(out["rendered"]).all()
    # a fg_motion without "gs" is Stage 2, whose trainer refuses a Stage-3
    # checkpoint
    with pytest.raises(ValueError, match="not a Stage-2 checkpoint"):
        trender.main(load + ["--fg_motion", "bob"])
