"""Two Stage-3 training steps of the port vs the JAX Stage3Trainer in its
default configuration (--fg_motion gs-bob with every loss option at its
JAX default: warp AdamW, flow as 2 extra kernel channels, cycle/skin
regularisers, feature reprojection), from the same converted state and the
same two batches.

The JAX step runs its CPU backend (raster_impl="tiles") with a per-tile
budget above the densest tile, so it composites every entry, as the port's
tile compositor does. Each case builds its JAX step once (a compile costs
tens of seconds):
* "2dgs_reg": the 2DGS normal and distortion terms on (use_2dgs_reg,
  lambda_dist > 0), the flow SNR gate off (flow_noise_px=0, so the
  synthetic GT flow supervises every pixel), strided feature subsample;
* "dssim": lambda_dssim=0.2, strided feature subsample;
* "grid_subsample": feat_reproj_px=300, whose stride does not divide the
  image, so the 2D-grid pixel subsample runs.

Tolerances:
* step 1: losses rtol 2e-5 (the rasterizer's module bound, averaged over
  pixels), gnorm 1e-3 relative (gradients summed in another order); Adam
  moments, surfel and warp: mu (gradients) and nu to 1e-3 * max |.| per
  field / parameter; deformer parameters after the first AdamW update
  within 2 lr x multiplier of each other (Adam's first step is
  ~lr * g / |g|, which flips sign where g is near 0), and to 1e-6 + 1e-3
  of that bound where |g| > 1e-2 max |g|;
* step 2 starts from parameters that already differ by those flips (up to
  2 lr; opacity lr 0.05): losses rtol 1e-4, gnorm 1e-3 (measured: <= 8e-6
  and 7e-5), moments to 2e-2 * max |.| (measured: <= 4.6e-3), deformer
  parameters within 2 x (sum of both steps' lr) x multiplier;
* densify stats after 2 steps: denom and max_radii2d exact, grad_accum
  5e-3 relative (measured: <= 7.5e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import assert_close, assert_close_to_max, n
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer as TTrainer
from vidu4d_tpu_torch.engine.optim import lr_multiplier

RES = 32
CASES = {
    "2dgs_reg": ({"lambda_dist": 0.1, "flow_noise_px": 0.0, "feat_reproj_px": 256}, True),
    "dssim": ({"lambda_dssim": 0.2, "feat_reproj_px": 256}, False),
    "grid_subsample": ({"feat_reproj_px": 300}, False),
}


def _opts(db, tmp, extra):
    return {
        "dataroot": db, "seqname": "toy", "logname": "parity",
        "logroot": os.path.join(str(tmp), "logdir"), "data_prefix": "crop",
        "train_res": RES, "pixels_per_image": -1, "imgs_per_gpu": 1,
        "fg_motion": "gs-bob", "gs_capacity": 448, "gs_init_samples": 400,
        "sh_degree": 3, **extra,
    }


@pytest.fixture(scope="module", params=list(CASES))
def steps(request, tmp_path_factory):
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.engine.schedules import progress_schedule
    from vidu4d_tpu.models.fields.time_mlp import init_intrinsics_base_params
    from vidu4d_tpu.models.gaussian import surfels as jsf
    from vidu4d_tpu.models.gaussian.optimizer import gs_adam_init

    extra, use_2dgs_reg = CASES[request.param]
    tmp = tmp_path_factory.mktemp("stage3_full")
    db = make_fake_db(tmp, num_vids=1, T=8, H=RES, W=RES)
    opts = _opts(db, tmp, extra)
    jt = JTrainer({**opts, "raster_impl": "tiles", "raster_budget": 2048,
                   "raster_tile_chunk": 4})
    # pixel-true intrinsics so the cloud renders (as bench.py does)
    prior = np.tile(np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32), (8, 1))
    p = dict(jt.params["params"])
    p["intrinsics"] = init_intrinsics_base_params(
        {"params": p["intrinsics"]}, prior, jt.frame_info)["params"]
    jt.params = {**jt.params, "params": p}
    # registration features, so the feature reprojection runs
    rng = np.random.default_rng(7)
    pts = np.asarray(jt.surfels.params.xyz)[:400]
    feats = rng.normal(size=(400, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    jt.surfels = jsf.init_from_points(
        jnp.asarray(pts), jnp.asarray(rng.uniform(size=(400, 3)), jnp.float32), 448,
        sh_degree=3, key=jax.random.PRNGKey(0), regist_feat=jnp.asarray(feats))
    jt.gs_adam = gs_adam_init(jt.surfels.params)
    batches = [jt._next_batch(), jt._next_batch()]
    weights = progress_schedule({**jt._loss_config(), "reg_eikonal_wt": 0.0}, 1000)
    before = jax.tree.map(np.array, (jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state))

    state = (jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state)
    jax_steps = []  # per step: (metrics, params, surfels, gs_adam, warp_opt_state)
    for b in batches:
        *state, m = jt._train_step(*state, b, weights, use_2dgs_reg=use_2dgs_reg)
        jax_steps.append(jax.tree.map(np.array, (m, *state)))

    tt = TTrainer(opts, "cpu")
    convert.load_flax_params_(tt.deformer, before[0])
    tt.set_surfels(convert.surfel_state_from_jax(before[1], "cpu"))
    tt.gs_adam = convert.gs_adam_from_jax(before[2], "cpu")
    tt.warp_opt.load_state(convert.warp_adamw_from_optax(before[3], tt.deformer, "cpu"))
    port_steps = []  # per step: (metrics, deformer params, gs_adam, warp mu, warp nu)
    for b in batches:
        m = tt.train_step({k: torch.tensor(np.asarray(v)) for k, v in b.items()},
                          use_2dgs_reg=use_2dgs_reg)
        clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
        port_steps.append((m, clone(dict(tt.deformer.named_parameters())),
                           tt.gs_adam._replace(mu=tt.gs_adam.mu._replace(**clone(
                               tt.gs_adam.mu._asdict())), nu=tt.gs_adam.nu._replace(
                               **clone(tt.gs_adam.nu._asdict()))),
                           clone(tt.warp_opt.mu), clone(tt.warp_opt.nu)))
    return request.param, jax_steps, tt, port_steps


TOL = [  # per step: loss rtol, moment rel tol
    (2e-5, 1e-3),
    (1e-4, 2e-2),
]


def test_losses_and_gnorm(steps):
    case, jax_steps, tt, port_steps = steps
    for i, ((j, *_), (t, *_)) in enumerate(zip(jax_steps, port_steps)):
        assert set(j) == set(t), (i, set(j) ^ set(t))
        for k in j:
            if k in ("alive", "overflow_splats", "truncated_entries"):
                assert int(j[k]) == int(t[k]), (i, k)
            elif k == "gnorm":
                assert_close(j[k], t[k], 0.0, 1e-3, f"step {i} {k}")
            else:
                assert_close(j[k], t[k], 1e-9, TOL[i][0], f"step {i} {k}")
        assert np.isfinite(float(t["gnorm"])) and float(t["gnorm"]) > 0
    keys = set(port_steps[0][0])
    assert {"flow", "feat_reproj", "reg_deform_cyc", "reg_delta_skin",
            "reg_skin_entropy"} <= keys
    assert ("normal_loss" in keys and "dist_loss" in keys) == (case == "2dgs_reg")
    assert ("rgb_ssim" in keys) == (case == "dssim")


def test_surfel_adam_moments(steps):
    _, jax_steps, tt, port_steps = steps
    for i, ((*_, ja, _), (_, _, ta, *_)) in enumerate(zip(jax_steps, port_steps)):
        assert int(ja.count) == ta.count == i + 1
        for f in ja.mu._fields:
            assert_close_to_max(getattr(ja.mu, f), getattr(ta.mu, f), TOL[i][1],
                                f"step {i} mu.{f}")
            assert_close_to_max(getattr(ja.nu, f), getattr(ta.nu, f), TOL[i][1],
                                f"step {i} nu.{f}")
        assert float(np.abs(np.asarray(ja.mu.regist_feat)).max()) > 0


def test_warp_adamw_moments_and_params(steps):
    _, jax_steps, tt, port_steps = steps
    opt = tt.warp_opt
    assert opt.count == 2
    lr_sum = 0.0
    for i, ((_, jparams, _, _, jw), (_, tparams, _, tmu, tnu)) in enumerate(
            zip(jax_steps, port_steps)):
        adam = convert.warp_adamw_from_optax(jw, tt.deformer, "cpu")
        assert adam["count"] == i + 1
        lr_sum += opt.schedule(i)
        jp = convert.flax_to_state_dict(jparams)
        moved = 0
        for name in tparams:
            mu_j = n(adam["mu"][name])
            assert_close_to_max(mu_j, tmu[name], TOL[i][1], f"step {i} mu {name}")
            assert_close_to_max(adam["nu"][name], tnu[name], TOL[i][1], f"step {i} nu {name}")
            bound = 2 * lr_sum * lr_multiplier(name)
            diff = np.abs(n(jp[name]) - n(tparams[name]))
            assert diff.max() <= bound + 1e-6, (i, name, diff.max(), bound)
            big = np.abs(mu_j) > 1e-2 * np.abs(mu_j).max()
            if i == 0 and big.any():
                assert diff[big].max() <= 1e-6 + 1e-3 * bound, (name, diff[big].max())
                moved += 1
        assert i > 0 or moved > 50


def test_densify_stats(steps):
    _, jax_steps, tt, _ = steps
    js = jax_steps[-1][2]
    s = tt.surfels
    assert float(np.asarray(js.grad_accum).max()) > 0
    assert np.array_equal(np.asarray(js.denom), n(s.denom))
    assert np.array_equal(np.asarray(js.max_radii2d), n(s.max_radii2d))
    assert_close_to_max(js.grad_accum, s.grad_accum, 5e-3, "grad_accum")


def test_use_2dgs_reg_follows_current_steps(tmp_path):
    """train_step(use_2dgs_reg=None) turns the normal and distortion terms
    on after 8k steps, and counts its steps."""
    db = make_fake_db(tmp_path, num_vids=1, T=8, H=16, W=16)
    tt = TTrainer({**_opts(db, tmp_path, {"lambda_dist": 0.1}), "train_res": 16,
                   "gs_capacity": 160, "gs_init_samples": 128}, "cpu")
    assert not tt.use_2dgs_reg(8000) and tt.use_2dgs_reg(8001)
    batch = tt._next_batch()
    m = tt.train_step(batch)
    assert tt.current_steps == 1 and "normal_loss" not in m and "dist_loss" not in m
    tt.current_steps = 8001
    m = tt.train_step(batch)
    assert tt.current_steps == 8002 and {"normal_loss", "dist_loss"} <= set(m)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert tt.warp_opt.count == 2
