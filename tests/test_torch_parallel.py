"""Data parallelism of the port (vidu4d_tpu_torch/parallel/sharding.py and
the trainers' --ngpu) on the CPU: 2 gloo ranks, spawned by
`sharding.spawn` over a file:// store in a temporary directory, against
one process from the same state and global batch, and against the JAX
package's one-device Stage3Trainer step.

Stage 3 runs at 16^2 with 128 slots, SH 1 and the options of
tests/test_sharded_trainers.py:_stage3_opts, from the JAX trainer's
initial state (pixel-true intrinsics, 16-dim registration features, so
that feature reprojection runs), converted:
* "even": 2 pairs, arap_wt 0.1 (each rank one pair; ARAP reads the global
  first pair, which rank 0 holds);
* "uneven": 3 pairs (every rank holds every pair at weight 1/2), the
  batch-independent volume term, DSSIM and the 2DGS terms on;
* "hooks": 3 steps of `train_one_round` with densify at every step, the
  opacity reset at 2 and the outlier prune at 3; the ranks' checksums
  agree after each hook.
Stage 2 runs one float64 step at 2 pairs x 8 px (field depth 2, width 32,
8 samples), from a state after 30 SDF pretrain steps, with fixed draws.
The command line runs 1 round of 2 Stage-3 steps with --ngpu 2 --device
cpu.

Tolerances: the ranks sum the same terms in another order, so in float32
(Stage 3) each loss term and gnorm agree within 1e-5 relative + 1e-9
(measured <= 2e-7 relative; after the 3 steps of "hooks" the cycle term,
a difference of nearly equal points of ~5e-6, 4.8e-11), every parameter, Adam moment and densify accumulator within
1e-5 of its tensor's max |.| + 1e-7 (a parameter at 0 moves by the first
AdamW step, ~2e-5, whatever its gradient's size, and g / (|g| + eps) with
|g| near eps carries the gradient's rounding: 1.1e-9 measured; 2e-8 on
O(1) parameters; 1e-6 after the 3 steps of "hooks"); the uneven case
replicates the rows at weight 1/2, exact in binary, and differs by
torch.mean's rounding against sum / count (7e-15 measured); alive and the
overflow / truncated counts are equal. Stage 2 in float64: 1e-9 relative. Against
JAX's one-device step: every metric, the deformer, the surfel store and
both optimisers' moments within the JAX sharded test's atol 1e-4 / rtol
1e-3.
"""

import os

import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
from vidu4d_tpu_torch.engine.optim import make_stage2_optimizer
from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.parallel import sharding

RES, CAP = 16, 128
S3_RTOL, S3_FLOOR = 1e-5, 1e-7
HOOKS_FLOOR = 1e-6  # after 3 steps
HOOKS = {"iters_per_round": 3, "densify_from_iter": 0, "densification_interval": 1,
         "opacity_reset_interval": 2, "outlier_filtering_interval": 3,
         "densify_grad_threshold": 1e-5}


def _stage3_opts(db, tmp, pairs, **extra):
    return {
        "dataroot": db, "seqname": "toy", "logname": "shard",
        "logroot": os.path.join(str(tmp), "logdir"), "data_prefix": "crop",
        "train_res": RES, "pixels_per_image": -1, "imgs_per_gpu": pairs, "num_rounds": 1,
        "iters_per_round": 1, "fg_motion": "gs-bob", "gs_capacity": CAP,
        "gs_init_samples": 64, "sh_degree": 1, "raster_budget": 64, "raster_tile_chunk": 1,
        "ngpu": 1, "seed": 0, **extra,
    }


def _stage2_opts(db, tmp):
    return {"dataroot": db, "seqname": "toy", "logname": "s2shard",
            "logroot": os.path.join(str(tmp), "logdir"), "data_prefix": "crop",
            "train_res": RES, "pixels_per_image": 8, "imgs_per_gpu": 2, "num_rounds": 2,
            "iters_per_round": 1, "fg_motion": "bob", "field_depth": 2, "field_width": 32,
            "train_depth_samples": 8, "ngpu": 1, "seed": 0}


def _tensors(x):
    return {k: v.detach().clone() for k, v in x.items()}


def _s3_state(tt):
    s, a, w = tt.surfels, tt.gs_adam, tt.warp_opt
    return {"deformer": _tensors(tt.deformer.state_dict()),
            "surfels": {f: v.detach().clone() for f, v in
                        zip(("params." + f for f in s.params._fields), s.params)},
            "stats": {f: getattr(s, f).clone() for f in s._fields[1:]},
            "gs_mu": _tensors(a.mu._asdict()), "gs_nu": _tensors(a.nu._asdict()),
            "warp_mu": _tensors(w.mu), "warp_nu": _tensors(w.nu)}


def _s3_case(mesh, case):
    """One Stage-3 case on this rank (``mesh`` None: one process)."""
    world = 1 if mesh is None else mesh.world
    tt = Stage3Trainer({**case["opts"], "ngpu": world,
                        "logname": f"{case['name']}-{world}"}, "cpu", group=mesh)
    s = case["store"]  # a store of the snapshot's shapes, then the snapshot's values
    tt.set_surfels(sf.SurfelState(sf.SurfelParams(*[p.clone().requires_grad_(True)
                                                    for p in s.params]),
                                  *(x.clone() for x in s[1:])))
    tt._restore(case["snap"])
    out = {"agree": [tt.ranks_agree()]}
    if case["batch"] is None:  # the round loop, with a checksum after each hook
        hooks = tt._densify_hooks

        def checked(span=1):
            hooks(span)
            out["agree"].append(tt.ranks_agree())

        tt._densify_hooks = checked
        out["metrics"] = tt.train_one_round()
        out["hook_log"] = [{k: int(v) if torch.is_tensor(v) else v for k, v in e.items()}
                           for e in tt.hook_log]
    else:
        batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
        out["metrics"] = tt.train_step(batch, use_2dgs_reg=case["use_2dgs_reg"])
    out["metrics"] = _tensors(out["metrics"])
    out["state"] = _s3_state(tt)
    return out


def _s3_rank(mesh, cases):
    torch.set_num_threads(1)
    return [_s3_case(mesh, c) for c in cases]


@pytest.fixture(scope="module")
def s3(tmp_path_factory):
    """The JAX one-device step on the even case's batch, and every case
    run by one process and by 2 ranks."""
    import jax
    import jax.numpy as jnp
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.engine.schedules import progress_schedule
    from vidu4d_tpu.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu.models.gaussian import surfels as jsf
    from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init

    tmp = tmp_path_factory.mktemp("parallel_s3")
    db = make_fake_db(tmp, num_vids=1, T=8, H=RES, W=RES)
    even = _stage3_opts(db, tmp, 2, arap_wt=0.1)
    # a per-tile budget above every tile's entries: JAX composites them all,
    # as the port's tile compositor does
    jt = JTrainer({**even, "logname": "jax", "raster_budget": 2048})
    prior = np.tile(np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32), (8, 1))
    p = dict(jt.params["params"])
    p["intrinsics"] = init_intrinsics_base_params(
        {"params": p["intrinsics"]}, prior, jt.frame_info)["params"]
    # the cloud 0.5 in front of the camera in every frame
    p["camera_mlp"] = jax.tree.map(np.array, p["camera_mlp"])
    p["camera_mlp"]["trans_head"]["Dense_0"]["bias"][2] += 0.5  # the output layer
    jt.params = {**jt.params, "params": jax.tree.map(jnp.asarray, p)}
    rng = np.random.default_rng(7)
    n = 96
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.03
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    jt.surfels = jsf.init_from_points(
        jnp.asarray(pts), jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32), CAP,
        sh_degree=1, key=jax.random.PRNGKey(0), regist_feat=jnp.asarray(feats))
    jt.gs_adam = gs_adam_init(jt.surfels.params)
    before = jax.tree.map(np.array, (jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state))
    batch = jax.tree.map(np.asarray, jt._next_batch())
    weights = progress_schedule({**jt._loss_config(), "reg_eikonal_wt": 0.0}, 0)
    *jax_state, jax_m = jt._train_step(*before, batch, weights, use_2dgs_reg=False)
    jax_out = jax.tree.map(np.array, (jax_m, *jax_state))

    tt = Stage3Trainer({**even, "logname": "convert"}, "cpu")
    convert.load_flax_params_(tt.deformer, before[0])
    tt.set_surfels(convert.surfel_state_from_jax(before[1], "cpu"))
    tt.gs_adam = convert.gs_adam_from_jax(before[2], "cpu")
    tt.warp_opt.load_state(convert.warp_adamw_from_optax(before[3], tt.deformer, "cpu"))
    snap = tt._snapshot()
    s = tt.surfels
    store = sf.SurfelState(sf.SurfelParams(*[p.detach().clone() for p in s.params]), *s[1:])
    uneven = _stage3_opts(db, tmp, 3, reg_volume_loss_wt=0.01, lambda_dssim=0.2,
                          lambda_dist=0.1)
    batch3 = {k: v.numpy() for k, v in Stage3Trainer(
        {**uneven, "logname": "batch3"}, "cpu")._next_batch().items()}
    cases = [
        {"name": "even", "opts": even, "snap": snap, "store": store, "batch": batch,
         "use_2dgs_reg": False},
        {"name": "uneven", "opts": uneven, "snap": snap, "store": store, "batch": batch3,
         "use_2dgs_reg": True},
        {"name": "hooks", "opts": {**even, **HOOKS}, "snap": snap, "store": store,
         "batch": None},
    ]
    one = _s3_rank(None, cases)
    ranks = sharding.spawn(_s3_rank, 2, args=(cases,), device="cpu")
    return {"jax": jax_out, "one": one, "ranks": ranks, "tt": tt,
            "names": [c["name"] for c in cases]}


def _case(s3, name):
    i = s3["names"].index(name)
    return s3["one"][i], [r[i] for r in s3["ranks"]]


def _assert_metrics(ref, got, rtol, name):
    assert set(ref) == set(got), (name, set(ref) ^ set(got))
    for k in ref:
        a, b = float(ref[k]), float(got[k])
        if k in ("alive", "overflow_splats", "truncated_entries"):
            assert a == b, (name, k, a, b)
        else:
            assert abs(a - b) <= rtol * abs(a) + 1e-9, (name, k, a, b)


def _assert_state(ref, got, rel, floor, name):
    for group in ref:
        for k, a in ref[group].items():
            b = got[group][k]
            if a.dtype == torch.bool or not a.is_floating_point():
                assert torch.equal(a, b), (name, group, k)
            elif a.numel():
                err = float((a.double() - b.double()).abs().max())
                assert err <= rel * float(a.abs().max()) + floor, (name, group, k, err)


@pytest.mark.parametrize("name", ["even", "uneven"])
def test_stage3_two_ranks_match_one_process(s3, name):
    """Every loss term, gnorm, alive and the coverage counts; the deformer,
    the surfel store with its densify accumulators and both optimisers'
    moments after the update, on both ranks."""
    one, ranks = _case(s3, name)
    for r, got in enumerate(ranks):
        assert all(got["agree"]), (name, r)
        _assert_metrics(one["metrics"], got["metrics"], S3_RTOL, f"{name} rank {r}")
        _assert_state(one["state"], got["state"], S3_RTOL, S3_FLOOR, f"{name} rank {r}")
    m = one["metrics"]
    terms = {"rgb", "flow", "depth", "mask", "feat_reproj", "reg_deform_cyc"}
    if name == "even":
        terms |= {"arap"}
    else:
        terms |= {"rgb_ssim", "reg_volume_loss", "normal_loss", "dist_loss"}
    assert terms <= set(m), sorted(terms - set(m))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(one["state"]["stats"]["denom"].sum()) > 0


def test_arap_counts_the_global_first_pair_once(s3):
    """arap_wt > 0 on 2 pairs: rank 0 holds global frames 0-1 and adds the
    term, rank 1 adds nothing; the sum is the one-process term."""
    one, ranks = _case(s3, "even")
    a = float(one["metrics"]["arap"])
    assert a > 0
    assert [float(r["metrics"]["arap"]) for r in ranks] == [float(ranks[0]["metrics"]["arap"])] * 2
    assert abs(float(ranks[0]["metrics"]["arap"]) - a) <= 1e-6 * a


def test_densify_hooks_agree_across_ranks(s3):
    """3 steps of train_one_round with densify at every step, the opacity
    reset at 2 and the outlier prune at 3: the ranks' checksums agree after
    the init and after each hook, the hooks' counts equal one process's,
    and so does the state after them."""
    one, ranks = _case(s3, "hooks")
    assert [e["hook"] for e in one["hook_log"]] == [
        "densify", "densify", "reset_opacity", "densify", "outlier"]
    assert sum(e.get("cloned", 0) + e.get("split", 0) for e in one["hook_log"]) > 0
    for r, got in enumerate(ranks):
        assert got["agree"] == [True] * 4, (r, got["agree"])
        assert got["hook_log"] == one["hook_log"], r
        _assert_state(one["state"], got["state"], S3_RTOL, HOOKS_FLOOR, f"hooks rank {r}")
        _assert_metrics(one["metrics"], got["metrics"], S3_RTOL, f"hooks rank {r}")


def test_two_ranks_match_the_jax_one_device_step(s3):
    """The port's 2-rank step against the JAX one-device trainer step on the
    same batch and state: every metric, the deformer parameters, the surfel
    store and both optimisers' moments (atol 1e-4 / rtol 1e-3)."""
    jm, jparams, jsurf, jadam, jwarp = s3["jax"]
    got = _case(s3, "even")[1][1]  # rank 1
    tol = dict(atol=1e-4, rtol=1e-3)
    assert set(jm) == set(got["metrics"]), set(jm) ^ set(got["metrics"])
    for k in jm:
        np.testing.assert_allclose(float(got["metrics"][k]), float(jm[k]), err_msg=k, **tol)
    jd = convert.flax_to_state_dict(jparams)
    for k, v in got["state"]["deformer"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jd[k]), err_msg=k, **tol)
    for f in jsurf.params._fields:
        np.testing.assert_allclose(got["state"]["surfels"][f"params.{f}"].numpy(),
                                   np.asarray(getattr(jsurf.params, f)), err_msg=f, **tol)
        np.testing.assert_allclose(got["state"]["gs_mu"][f].numpy(),
                                   np.asarray(getattr(jadam.mu, f)), err_msg=f, **tol)
        np.testing.assert_allclose(got["state"]["gs_nu"][f].numpy(),
                                   np.asarray(getattr(jadam.nu, f)), err_msg=f, **tol)
    for f in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(got["state"]["stats"][f].numpy(),
                                   np.asarray(getattr(jsurf, f)), err_msg=f, **tol)
    adam = convert.warp_adamw_from_optax(jwarp, s3["tt"].deformer, "cpu")
    for k in got["state"]["warp_mu"]:
        np.testing.assert_allclose(got["state"]["warp_mu"][k].numpy(),
                                   adam["mu"][k].numpy(), err_msg=k, **tol)
        np.testing.assert_allclose(got["state"]["warp_nu"][k].numpy(),
                                   adam["nu"][k].numpy(), err_msg=k, **tol)


# ----------------------------------------------------------------------
# Stage 2
# ----------------------------------------------------------------------


def _s2_state(tr):
    return {"params": _tensors(dict(tr.model.named_parameters())),
            "mu": _tensors(tr.optimizer.mu), "nu": _tensors(tr.optimizer.nu)}


def _s2_rank(mesh, opts, sd, states, batch, draws):
    torch.set_num_threads(1)
    world = 1 if mesh is None else mesh.world
    tr = Stage2Trainer({**opts, "ngpu": world, "logname": f"s2-{world}"}, "cpu", group=mesh)
    tr.model.double()
    tr.model.load_state_dict(sd)
    tr.states = {c: FieldState(*[x.clone() for x in st]) for c, st in states.items()}
    tr.optimizer = make_stage2_optimizer(tr.model, 5e-4, 2, 2)
    agree = [tr.ranks_agree()]
    m = tr.train_step(dict(batch), dict(draws))
    agree.append(tr.ranks_agree())
    return {"metrics": _tensors(m), "state": _s2_state(tr), "agree": agree}


@pytest.fixture(scope="module")
def s2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_s2")
    db = make_fake_db(tmp, num_vids=1, T=8, H=RES, W=RES)
    opts = _stage2_opts(db, tmp)
    tr = Stage2Trainer({**opts, "logname": "s2-init"}, "cpu")
    # a short SDF pretrain: from the random init every ray's mask is ~1
    tr._geometry_init(sdf_iters=30, verbose=False)
    tr.update_geometry_aux(beta=0.0)
    tr.model.double()
    sd = _tensors(tr.model.state_dict())
    states = {c: FieldState(*[x.double() for x in st]) for c, st in tr.states.items()}
    f64 = lambda d: {k: v.double() if v.is_floating_point() else v for k, v in d.items()}
    batch = f64(tr._next_batch())
    draws = f64(tr.model.reg_draws(torch.Generator().manual_seed(0)))
    args = (opts, sd, states, batch, draws)
    return _s2_rank(None, *args), sharding.spawn(_s2_rank, 2, args=args, device="cpu")


def test_stage2_two_ranks_match_one_process_float64(s2):
    """One float64 Stage-2 step: every loss term (the sampled regularisers
    and the camera prior on rank 0 only), gnorm, every parameter after
    the AdamW update and its moments, on both ranks, within 1e-9
    relative."""
    one, ranks = s2
    m = one["metrics"]
    assert {"rgb", "mask", "flow", "depth", "vis", "reg_eikonal", "reg_visibility",
            "reg_gauss_skin", "reg_cam_prior", "feature", "feat_reproj"} <= set(m), sorted(m)
    for r, got in enumerate(ranks):
        assert got["agree"] == [True, True], r
        assert set(got["metrics"]) == set(m)
        for k in m:
            a, b = float(m[k]), float(got["metrics"][k])
            assert abs(a - b) <= 1e-9 * abs(a) + 1e-300, (r, k, a, b)
        for group in one["state"]:
            for k, a in one["state"][group].items():
                err = float((a - got["state"][group][k]).abs().max())
                assert err <= 1e-9 * float(a.abs().max()) + 1e-300, (r, group, k, err)
    moved = [k for k, v in one["state"]["params"].items() if float(v.abs().max()) > 0]
    assert len(moved) > 10


# ----------------------------------------------------------------------
# the command line and the ranks' files
# ----------------------------------------------------------------------


def test_cli_ngpu2_cpu_matches_one_process(tmp_path, monkeypatch):
    """train.main --ngpu 2 --device cpu, 1 round of 2 Stage-3 steps: the
    run's files are written (opts.log by the launching process, the rest by
    rank 0), and its checkpoint equals a one-process run's within the
    float32 bound; the deformer within 2 x the two steps' learning rates x
    its multiplier besides (the random camera leaves the cloud out of view,
    and Adam's ~lr * g / |g| flips where a gradient is rounding noise:
    4.2e-7 measured on a time embedding)."""
    from vidu4d_tpu_torch import train as ttrain
    from vidu4d_tpu_torch.engine.optim import lr_multiplier, onecycle_linear

    make_fake_db(tmp_path, num_vids=1, T=8, H=RES, W=RES)
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--seqname", "toy", "--fg_motion", "gs-bob",
              "--gs_capacity", str(CAP), "--train_res", str(RES), "--imgs_per_gpu", "2",
              "--pixels_per_image", "-1", "--num_rounds", "1", "--iters_per_round", "2",
              "--save_freq", "1", "--sh_degree", "1", "--seed", "0"]
    assert ttrain.main(common + ["--logname", "two", "--ngpu", "2"]) is None
    one = ttrain.main(common + ["--logname", "one"])
    names = {"opts.log", "opts.json", "ckpt_0001.pth", "ckpt_latest.pth",
             "point_cloud_0001.ply"}
    assert names <= set(os.listdir(tmp_path / "logdir" / "toy-two"))
    a = convert.load_jax_checkpoint(str(tmp_path / "logdir" / "toy-one" / "ckpt_latest.pth"))
    b = convert.load_jax_checkpoint(str(tmp_path / "logdir" / "toy-two" / "ckpt_latest.pth"))
    assert (a["current_steps"], b["current_steps"]) == (2, 2) and one.current_steps == 2
    assert b["opts"]["ngpu"] == 2

    def flat(x, prefix=""):
        if isinstance(x, dict):
            return {k2: v2 for k, v in x.items() for k2, v2 in flat(v, f"{prefix}{k}/").items()}
        if hasattr(x, "_asdict"):
            return flat(x._asdict(), prefix)
        return {prefix: x}

    fa, fb = (flat({k: p[k] for k in ("params", "surfels", "gs_adam")}) for p in (a, b))
    assert fa.keys() == fb.keys()
    schedule = onecycle_linear(5e-4, 2, 1)
    lr_sum = schedule(0) + schedule(1)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        if x.dtype.kind in "biu":
            assert np.array_equal(x, y), k
        elif x.size:
            bound = S3_RTOL * np.abs(x).max() + S3_FLOOR
            if k.startswith("params/"):
                bound += 2 * lr_sum * lr_multiplier(k.split("/")[1])
            assert np.abs(x - y).max() <= bound, k


def _rank_writes(mesh, opts):
    """A 2-step round of a rank whose log root is its own."""
    torch.set_num_threads(1)
    tt = Stage3Trainer({**opts, "ngpu": mesh.world,
                        "logroot": os.path.join(opts["logroot"], f"rank{mesh.rank}")},
                       "cpu", group=mesh)
    tt.train()
    return tt.current_steps


def test_only_rank_zero_writes(tmp_path):
    """With each rank's log root its own, rank 1 leaves no file: no
    opts.json, checkpoint, .ply or log."""
    db = make_fake_db(tmp_path, num_vids=1, T=8, H=RES, W=RES)
    opts = {**_stage3_opts(db, tmp_path, 2), "iters_per_round": 2, "save_freq": 1}
    assert sharding.spawn(_rank_writes, 2, args=(opts,), device="cpu") == [2, 2]
    root = tmp_path / "logdir"
    assert {"opts.json", "ckpt_0001.pth", "point_cloud_0001.ply"} <= set(
        os.listdir(root / "rank0" / "toy-shard"))
    assert not (root / "rank1").exists()


# ----------------------------------------------------------------------
# the group descriptor, the share and the launch checks
# ----------------------------------------------------------------------


def test_pair_shares():
    """Whole pairs, contiguous and equal when they divide; otherwise every
    pair on every rank at weight 1 / world; shard_batch slices frames."""
    mesh = lambda r, w: sharding.Mesh(r, w, "gloo", torch.device("cpu"))
    assert sharding.pair_share(4, mesh(1, 2))[1:] == (2, 4, 1.0)
    assert sharding.pair_share(3, mesh(1, 2))[1:] == (0, 3, 0.5)
    assert sharding.pair_share(1, mesh(0, 2))[1:] == (0, 1, 0.5)
    batch = {"frameid": torch.arange(8), "rgb": torch.arange(16).reshape(8, 2),
             "other": torch.zeros(3)}
    rows, share = sharding.shard_batch(batch, mesh(1, 2))
    assert rows["frameid"].tolist() == [4, 5, 6, 7] and rows["rgb"].shape == (4, 2)
    assert rows["other"].shape == (3,) and share.holds_first is False and not share.root
    with pytest.raises(ValueError, match="whole pairs"):
        sharding.shard_batch({"frameid": torch.arange(3)}, mesh(0, 2))


def test_ngpu_above_the_visible_cards_raises(tmp_path, monkeypatch):
    """--ngpu above the visible cards raises ValueError naming both numbers;
    a trainer with ngpu 2 and no process group raises too (nothing falls
    back to one process)."""
    from vidu4d_tpu_torch import train as ttrain

    n = sharding.visible_cards()
    k = max(n + 1, 2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=f"--ngpu {k} needs {k} CUDA devices, but "
                                         f"{n} are visible"):
        ttrain.main(["--seqname", "toy", "--logname", "x", "--fg_motion", "gs-bob",
                     "--ngpu", str(k)])
    db = make_fake_db(tmp_path, num_vids=1, T=8, H=RES, W=RES)
    with pytest.raises(ValueError, match="2 ranks asked for, but this process's group has 1"):
        Stage3Trainer({**_stage3_opts(db, tmp_path, 2), "ngpu": 2}, "cpu")
    with pytest.raises(ValueError, match="data_axis"):
        sharding.make_mesh(1, data_axis=2)


def test_launcher_with_cuda_asked_never_falls_back_to_cpu(tmp_path, monkeypatch):
    """Under a launcher (WORLD_SIZE 2), the default --device cuda with CUDA
    hidden raises before any group is made, and a local rank without a
    card raises ValueError naming both numbers: nothing moves to the CPU or
    to gloo. Only --device cpu makes a gloo group on the CPU."""
    from vidu4d_tpu_torch import train as ttrain

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda asked for, but CUDA is not available"):
        ttrain.main(["--seqname", "toy", "--logname", "x", "--fg_motion", "gs-bob",
                     "--ngpu", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh(2, device="cuda")
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="local rank 1 needs CUDA device 1, but 1 are visible"):
        sharding.make_mesh(2, device="cuda")
    assert not torch.distributed.is_initialized()
    assert sharding.rank_device("cpu", 1) == torch.device("cpu")


# ----------------------------------------------------------------------
# the per-host data draws
# ----------------------------------------------------------------------


def test_host_slice_and_host_map_match_jax(monkeypatch):
    """host_slice with explicit and default (one node) indices and
    host_map's three methods equal the JAX package's; a launcher's
    environment makes the node index the default."""
    from vidu4d_tpu.utils import host_map as jhm
    from vidu4d_tpu_torch.utils import host_map as thm

    items = list(range(23))
    for pi, pc in ((None, None), (0, 1), (1, 2), (2, 3), (4, 5)):
        assert thm.host_slice(items, pi, pc) == jhm.host_slice(items, pi, pc), (pi, pc)
    for method in ("sequential", "thread", "process"):
        args = [(i, i + 1) for i in range(5)] + [7]
        assert thm.host_map(_add, args, method, 2) == jhm.host_map(_add, args, method, 2)
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "5")
    assert (thm.node_index(), thm.node_count()) == (1, 2)
    assert thm.host_slice(items) == items[1::2]
    monkeypatch.setenv("GROUP_RANK", "0")
    assert thm.node_index() == 0


def _add(a, b=0):
    return a + b


@pytest.mark.parametrize("num_hosts,host_id", [(2, 1), (2, 0), (1, 0)])
def test_pair_batcher_per_host_draws_match_jax(tmp_path, num_hosts, host_id):
    """PairBatcher(num_hosts, host_id): the host's slice of the (video,
    frame) index and the seed + host_id rng draw JAX's batches bitwise; the
    default (no launcher) is JAX's one process."""
    from vidu4d_tpu.data import data_utils as jdata
    from vidu4d_tpu_torch.data import data_utils as tdata

    db = make_fake_db(tmp_path, num_vids=2, T=8, H=RES, W=RES)
    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop", "train_res": RES,
            "pixels_per_image": 4, "seed": 3}
    jb = jdata.PairBatcher(jdata.build_datasets(opts), 3, seed=3, num_hosts=num_hosts,
                           host_id=host_id)
    tb = tdata.PairBatcher(tdata.build_datasets(opts), 3, seed=3, num_hosts=num_hosts,
                           host_id=host_id)
    assert tb.index == jb.index
    if num_hosts == 1:  # the defaults: one node
        assert tdata.PairBatcher(tdata.build_datasets(opts), 3, seed=3).index == jb.index
    for _ in range(3):
        a, b = jb.next_batch(), tb.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_trainers_draw_the_one_host_batch_on_any_node(tmp_path, monkeypatch):
    """Under a launcher over several nodes (this process on node 1 of 2),
    both trainers still draw the whole global batch as one host does (the
    datasets' rng and the pair picks of host 0 of 1), so that
    `sharding.shard_batch` alone splits it: every rank of every node holds
    its share of the one-process batch."""
    db = make_fake_db(tmp_path, num_vids=2, T=8, H=RES, W=RES)

    def batches():
        out = []
        for cls, opts in ((Stage3Trainer, _stage3_opts(db, tmp_path, 2)),
                          (Stage2Trainer, _stage2_opts(db, tmp_path))):
            tt = cls(opts, "cpu")
            out.append([tt._next_batch() for _ in range(2)])
        return out

    ref = batches()
    for k, v in {"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "2", "RANK": "3",
                 "LOCAL_RANK": "1", "GROUP_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    for want, got in zip(ref, batches()):
        for a, b in zip(want, got):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
