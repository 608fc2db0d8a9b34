"""The warp AdamW's rate over a 1-round run, in the port and in the JAX
package, from one Stage-2 output: the one chip_smoke.py's command-line
phase writes (`torch_parity.write_stage2_output`: the ellipsoid shell mesh,
a camera at the identity pose 0.38 in front of it, the pixel-true
intrinsics), here at 32x32, 16 frames, 2048 surfels on the mesh.

A run of 1 round of 10 steps warms the OneCycle rate up from lr / 25 to lr
within its 10 steps (the README recipe's 61 rounds of 200 warm up over
400 steps, at 2e-5 .. 3.1e-5 in its first 10). At the default lr 5e-4 the
camera MLP's translation and the focal length move far in those steps, in
both packages alike, and the cloud leaves part of the view; at 3e-5, the
smoke's rate, they hardly move and the view keeps its cover.

The port gets the JAX trainer's state after `load_stage2` (its surfel
rotations included) and the same batches; one JAX trainer serves both
rates (its warp optimiser and step are built again for the second).
Measured (JAX / port, CPU): at 5e-4 frame 0's translation moves from
(0, 0, 0.475) to (0.152, 0.117, 0.367) / (0.151, 0.118, 0.366) and its
focal length from 38.4 to 87.0 / 87.7 px; the ref cover falls from
0.51-0.55 to 0.15-0.55; at 3e-5 the translation moves by 1.3e-3, the focal
length to 39.9 px, and the cover stays at 0.55-0.59.

Tolerances, port vs JAX after each step: translations within 2% of how
far JAX's moved from the start (+1e-5), focal lengths within 2% relative
(Adam's first steps are lr * sign(g), which flips where g is near 0, and
the default rate carries such flips into every later step: 0.7% and 1.2%
after step 10 at 5e-4, 1e-6 and 2e-5 at 3e-5); the ref cover of each frame
(mask > 0.01) within 0.02 (20 of 1024 pixels; the focal lengths' 1.2%
moves the silhouette).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from tests.torch_parity import write_stage2_output
from vidu4d_tpu_torch import config, convert
from vidu4d_tpu_torch import render as trender
from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer as TTrainer

RES, T, CAP, STEPS = 32, 16, 2048, 10
DEFAULT_LR, SMOKE_LR = 5e-4, 3e-5
TRANS_REL, FOCAL_REL, COVER_ABS = 2e-2, 2e-2, 0.02


def _opts(db, logroot, mesh, logname, lr):
    return {"dataroot": db, "seqname": "toy", "logname": logname, "logroot": logroot,
            "data_prefix": "crop", "train_res": RES, "pixels_per_image": -1,
            "imgs_per_gpu": 1, "fg_motion": "gs-bob", "gs_capacity": CAP,
            "gs_init_samples": CAP, "gs_init_mesh": mesh, "num_rounds": 1,
            "iters_per_round": STEPS, "learning_rate": lr}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX trainer after load_stage2, its state as numpy, the batches
    of the run, and the options."""
    from vidu4d_tpu.engine.gs4d_trainer import Stage3Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("warp_lr")
    db = make_fake_db(tmp, num_vids=1, T=T, H=RES, W=RES)
    mesh, ckpt, _ = write_stage2_output(str(tmp / "logdir" / "toy-s2"), db, RES,
                                        np.random.default_rng(1234))
    logroot = str(tmp / "logdir")
    jt = JTrainer({**_opts(db, logroot, mesh, "jax", DEFAULT_LR), "raster_impl": "tiles",
                   "raster_budget": CAP, "raster_tile_chunk": 4})
    jt.load_stage2(ckpt)
    before = jax.tree.map(np.array, (jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state))
    batches = [jt._next_batch() for _ in range(STEPS)]
    return {"jt": jt, "before": before, "batches": batches, "db": db, "logroot": logroot,
            "mesh": mesh}


def _cover(out):
    return (np.asarray(out["mask"]) > 0.01).mean(axis=(1, 2, 3))


def _run_both(setup, lr):
    """Both trainers from the post-transfer state at rate ``lr``, 10 steps
    of 1 step per round; per step each one's (translations, focal lengths)
    of the 16 frames, and each one's ref cover before and after."""
    from vidu4d_tpu import render as jrender
    from vidu4d_tpu.engine.optim import make_stage2_optimizer

    jt, before = setup["jt"], setup["before"]
    if lr != jt.opts["learning_rate"]:
        jt.opts["learning_rate"] = lr
        jt.warp_opt = make_stage2_optimizer(before[0], learning_rate=lr, total_steps=STEPS,
                                            num_rounds=1)
        jt._train_step = jt._build_train_step()
    # strongly typed leaves, so that the step compiles once
    jt.params, jt.surfels, jt.gs_adam, jt.warp_opt_state = jax.tree.map(jnp.asarray, before)
    jt.current_steps = jt.current_round = 0
    tt = TTrainer(_opts(setup["db"], setup["logroot"], setup["mesh"], f"port_{lr}", lr), "cpu")
    convert.load_flax_params_(tt.deformer, before[0])
    tt.set_surfels(convert.surfel_state_from_jax(before[1], "cpu"))
    tt.gs_adam = convert.gs_adam_from_jax(before[2], "cpu")
    tt.warp_opt.load_state(convert.warp_adamw_from_optax(before[3], tt.deformer, "cpu"))
    jfeed = iter(setup["batches"])
    tfeed = iter([{k: torch.tensor(np.asarray(v)) for k, v in b.items()}
                  for b in setup["batches"]])
    jt._next_batch = lambda: next(jfeed)
    tt._next_batch = lambda: next(tfeed)
    for o in (jt.opts, tt.opts):
        o["iters_per_round"] = 1

    frames = np.arange(T)
    ref = {**{k: d for k, (_, d) in config.RENDER_FLAGS.items()}, "render_res": RES}

    def cameras():
        return [(np.asarray(get_cam(tr, frames))[:, :3, 3], np.asarray(get_k(tr, frames))[:, 0])
                for tr, get_cam, get_k in (
                    (jt, jrender.get_field_cameras, jrender.get_intrinsics),
                    (tt, trender.get_field_cameras, trender.get_intrinsics))]

    def covers():
        jb = jrender.construct_batch_from_opts(ref, jt)
        tb = trender.construct_batch_from_opts(ref, tt)
        return _cover(jt.render_batch(jb, res=RES)), _cover(tt.render_batch(tb, res=RES))

    cover0, steps = covers(), [cameras()]
    for _ in range(STEPS):
        jt.train_one_round()
        tt.train_one_round()
        steps.append(cameras())
    return steps, cover0, covers()


def _assert_port_follows_jax(steps, cover0, cover1):
    (t_init, _), _ = steps[0]
    for i, ((tj, fj), (tp, fp)) in enumerate(steps):
        moved = float(np.abs(tj - t_init).max())
        assert np.abs(tp - tj).max() <= TRANS_REL * moved + 1e-5, (i, tj[0], tp[0])
        assert np.abs(fp / fj - 1.0).max() <= FOCAL_REL, (i, fj[0], fp[0])
    for j, p in (cover0, cover1):
        assert np.abs(p - j).max() <= COVER_ABS, (j, p)


def test_default_rate_moves_the_camera_in_both(setup):
    """At 5e-4 over 1 round of 10 steps the port's camera follows JAX's
    step by step, and in both the translation moves by > 0.1 (the mesh's
    semi-axes are 0.07-0.12), the focal length grows > 1.5x, and some
    frame's cover falls below half of what it was."""
    steps, cover0, cover1 = _run_both(setup, DEFAULT_LR)
    print("5e-4: frame 0 translation, focal (jax, port):",
          [(tj[0].round(4).tolist(), tp[0].round(4).tolist(), float(fj[0]), float(fp[0]))
           for (tj, fj), (tp, fp) in steps], "cover before", cover0, "after", cover1)
    _assert_port_follows_jax(steps, cover0, cover1)
    (t_init, f_init), _ = steps[0]
    for t_end, f_end in steps[-1]:
        assert np.abs(t_end - t_init).max() > 0.1
        assert (f_end / f_init).min() > 1.5
    for before, after in zip(cover0, cover1):
        assert (after / before).min() < 0.5


def test_smoke_rate_keeps_the_camera_in_both(setup):
    """At 3e-5 (chip_smoke.py's command-line phase) the port follows JAX
    and in both the translation moves by < 0.01, the focal length by < 10%,
    and every frame keeps >= 90% of its cover."""
    steps, cover0, cover1 = _run_both(setup, SMOKE_LR)
    print("3e-5: frame 0 translation, focal (jax, port):",
          [(tj[0].round(5).tolist(), tp[0].round(5).tolist(), float(fj[0]), float(fp[0]))
           for (tj, fj), (tp, fp) in steps], "cover before", cover0, "after", cover1)
    _assert_port_follows_jax(steps, cover0, cover1)
    (t_init, f_init), _ = steps[0]
    for t_end, f_end in steps[-1]:
        assert np.abs(t_end - t_init).max() < 0.01
        assert np.abs(f_end / f_init - 1.0).max() < 0.1
    for before, after in zip(cover0, cover1):
        assert (after / before).min() >= 0.9
