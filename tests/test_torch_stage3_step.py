"""One Stage-3 training step of the port vs the JAX Stage3Trainer, in the
reduced configuration (--fg_motion gs-bob --nogs_optim_warp --rgb_loss_only
--flow_wt 0), from the same converted parameters and the same batch. The
default configuration is held in tests/test_torch_stage3_full_step.py.

The JAX step runs its CPU backend (raster_impl="tiles") with a per-tile
budget above the densest tile, so it composites every entry, as the port's
tile compositor does.

Tolerances:
* losses: rtol 2e-5 (affine-form vs direct cross product rounding, the
  module bound of tests/test_torch_rasterize.py, averaged over pixels);
* gnorm, gradients (Adam mu / (1 - b1)) and nu: 1e-3 relative (gradients
  of 2 x 1k-pixel renders through the warp, summed in another order);
* updated params: 1e-6 where the gradient is not tiny; Adam's first step is
  lr * g / |g|, which flips sign with a near-zero g, so elsewhere within
  2 * lr of each other;
* densify stats: denom / max_radii2d exact, grad_accum 1e-3 relative.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import assert_close, assert_close_to_max, n
from vidu4d_tpu.data import data_utils
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.data.data_utils import PairBatcher
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer as TTrainer
from vidu4d_tpu_torch.models.gaussian.optimizer import field_lrs

RES = 32
SLICE = {"gs_optim_warp": False, "rgb_loss_only": True, "flow_wt": 0.0}


def _opts(db, tmp):
    return {
        "dataroot": db, "seqname": "toy", "logname": "parity",
        "logroot": os.path.join(str(tmp), "logdir"), "data_prefix": "crop",
        "train_res": RES, "pixels_per_image": -1, "imgs_per_gpu": 1,
        "fg_motion": "gs-bob", "gs_capacity": 448, "gs_init_samples": 400,
        "sh_degree": 3, **SLICE,
    }


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer
    from vidu4d_tpu.engine.schedules import progress_schedule
    from vidu4d_tpu.models.fields.time_mlp import init_intrinsics_base_params

    tmp = tmp_path_factory.mktemp("stage3")
    db = make_fake_db(tmp, num_vids=1, T=8, H=RES, W=RES)
    opts = _opts(db, tmp)
    jt = JTrainer({**opts, "raster_impl": "tiles", "raster_budget": 2048,
                   "raster_tile_chunk": 4})
    # pixel-true intrinsics so the cloud renders (as bench.py does)
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
    tm = tt.train_step({k: torch.tensor(np.asarray(v)) for k, v in batch.items()})
    return jax_out, tt, tm


def test_step_losses_and_gnorm(steps):
    (js, ja, jm), tt, tm = steps
    assert int(jm["alive"]) == int(tm["alive"]) == 400
    for k in ("total", "rgb", "mask", "depth"):
        assert_close(jm[k], tm[k], 0.0, 2e-5, k)
    assert_close(jm["gnorm"], tm["gnorm"], 0.0, 1e-3, "gnorm")
    assert np.isfinite(float(tm["gnorm"])) and float(tm["gnorm"]) > 0
    assert int(jm["overflow_splats"]) == int(tm["overflow_splats"])


def test_step_adam_moments_and_params(steps):
    (js, ja, jm), tt, tm = steps
    assert int(ja.count) == tt.gs_adam.count == 1
    lrs = field_lrs(tt.gs_lrs, 1.0)
    for f in js.params._fields:
        if f == "regist_feat":
            continue
        mu_j, mu_t = getattr(ja.mu, f), getattr(tt.gs_adam.mu, f)
        assert_close_to_max(mu_j, mu_t, 1e-3, f"mu.{f}")
        assert_close_to_max(getattr(ja.nu, f), getattr(tt.gs_adam.nu, f), 2e-3, f"nu.{f}")
        p_j, p_t = np.asarray(getattr(js.params, f)), n(getattr(tt.surfels.params, f))
        lr = getattr(lrs, f)
        assert np.abs(p_j - p_t).max() <= 2 * lr + 1e-6, f
        big = np.abs(mu_j) > 1e-2 * np.abs(mu_j).max()
        assert np.abs(p_j - p_t)[big].max() <= 1e-6, f


def test_step_densify_stats(steps):
    (js, ja, jm), tt, tm = steps
    s = tt.surfels
    assert np.array_equal(np.asarray(js.denom), n(s.denom))
    assert np.array_equal(np.asarray(js.max_radii2d), n(s.max_radii2d))
    assert float(np.asarray(js.grad_accum).max()) > 0
    assert_close_to_max(js.grad_accum, s.grad_accum, 1e-3, "grad_accum")


def test_pair_sampler_matches_pair_batcher(tmp_path):
    """The port's batches are the JAX trainer's PairBatcher draws (one host)."""
    db = make_fake_db(tmp_path, num_vids=2, T=8, H=16, W=16)
    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop",
            "train_res": 16, "pixels_per_image": -1}
    mk = lambda: data_utils.build_datasets(opts, rng=np.random.default_rng(1))
    ref = data_utils.PairBatcher(mk(), 2, seed=3, num_hosts=1, host_id=0)
    got = PairBatcher(mk(), 2, seed=3)
    for _ in range(3):
        a, b = ref.next_batch(), got.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("bad", [
    {"gs_init_ply": "point_cloud.ply"},
    {"fg_motion": "gs-dense"}, {"pixels_per_image": 16}, {"ngpu": 2},
    {"raster_impl": "tiles"}, {"raster_tile": 12},
])
def test_unported_options_raise(tmp_path, bad):
    """Options the port does not take raise NotImplementedError; ngpu 2,
    which it takes over a process group of 2 ranks, raises ValueError in a
    process without one (nothing falls back to one process)."""
    db = make_fake_db(tmp_path, num_vids=1, T=8, H=16, W=16)
    err = ValueError if "ngpu" in bad else NotImplementedError
    with pytest.raises(err):
        TTrainer({**_opts(db, tmp_path), **bad}, "cpu")


def test_nosingle_inst_trainer_takes_a_step(tmp_path):
    """--nosingle_inst (one instance code per video) builds on a 2-video
    database and takes a step of batches from both videos: finite, the
    surfels moved."""
    from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params

    db = make_fake_db(tmp_path, num_vids=2, T=8, H=16, W=16)
    tt = TTrainer({**_opts(db, tmp_path), "train_res": 16, "single_inst": False,
                   "gs_capacity": 256, "gs_init_samples": 200, "imgs_per_gpu": 4}, "cpu")
    assert tt.deformer.num_inst == 2
    prior = np.tile(np.array([19.2, 19.2, 8.0, 8.0], np.float32), (18, 1))
    init_intrinsics_base_params(tt.deformer.intrinsics, prior, tt.frame_info)
    with torch.no_grad():  # move the random cloud 0.5 in front of the camera
        tt.deformer.camera_mlp.trans_head.out.bias[2] += 0.5
    xyz0 = tt.surfels.params.xyz.detach().clone()
    batch = tt._next_batch()
    assert set(n(batch["dataid"]).tolist()) == {0, 1}
    m = tt.train_step(batch)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(xyz0, tt.surfels.params.xyz.detach())


def test_trainer_step_runs_on_its_own_state(tmp_path):
    """The port's own seeded init + _next_batch + two steps: finite, moving."""
    from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params

    db = make_fake_db(tmp_path, num_vids=1, T=8, H=RES, W=RES)
    tt = TTrainer({**_opts(db, tmp_path), "gs_capacity": 256, "gs_init_samples": 200},
                  "cpu")
    prior = np.tile(np.array([1.2 * RES, 1.2 * RES, RES / 2, RES / 2], np.float32), (8, 1))
    init_intrinsics_base_params(tt.deformer.intrinsics, prior, tt.frame_info)
    with torch.no_grad():  # move the random cloud 0.5 in front of the camera
        tt.deformer.camera_mlp.trans_head.out.bias[2] += 0.5
    xyz0 = tt.surfels.params.xyz.detach().clone()
    batch = tt._next_batch()
    assert batch["rgb"].shape == (2, RES * RES, 3) and batch["frameid"].shape == (2,)
    m1, m2 = tt.train_step(batch), tt.train_step()
    for m in (m1, m2):
        assert all(np.isfinite(float(v)) for v in m.values())
    assert tt.gs_adam.count == 2 and float(m1["gnorm"]) > 0
    assert not torch.equal(xyz0, tt.surfels.params.xyz.detach())
