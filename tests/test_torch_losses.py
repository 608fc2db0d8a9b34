"""Parity of the port's loss-stack pieces with the JAX package: pinhole
projection, flip_pair, the ARAP bone loss, pseudo normals from depth, the
image losses (SSIM), the schedules, the feature-loss pixel subsample and
the warp AdamW (against the optax chain of make_stage2_optimizer).

Tolerances: float32 elementwise math agrees to a few ulps (atol/rtol
1e-6 .. 2e-6); sums, convolutions and products of normalised vectors
(ARAP, SSIM, normals) 1e-5; AdamW parameters and moments after 3 updates
atol 1e-6 / rtol 1e-5 (float32 Adam in both; the schedule is float64 in
the port and float32 in optax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tests.torch_parity import assert_close, grad_parity, t
from vidu4d_tpu.engine import optim as joptim
from vidu4d_tpu.engine import schedules as jsched
from vidu4d_tpu.models.fields import dyn_nerf as jdyn
from vidu4d_tpu.models.fields import skinning as jskin
from vidu4d_tpu.ops import depth_normal as jdn
from vidu4d_tpu.ops import geometry as jgeom
from vidu4d_tpu.ops import image_losses as jimg
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine import optim as toptim
from vidu4d_tpu_torch.engine import schedules as tsched
from vidu4d_tpu_torch.models.fields import dyn_nerf as tdyn
from vidu4d_tpu_torch.models.fields import skinning as tskin
from vidu4d_tpu_torch.ops import depth_normal as tdn
from vidu4d_tpu_torch.ops import geometry as tgeom
from vidu4d_tpu_torch.ops import image_losses as timg


def test_pinhole_projection_with_points_at_the_camera_plane():
    rng = np.random.default_rng(0)
    kmat = np.asarray(jgeom.K2mat(np.abs(rng.normal(size=(2, 4))) * 20 + 5), np.float32)
    xyz = rng.normal(size=(2, 7, 3)).astype(np.float32)
    xyz[..., 2] += 3.0
    xyz[0, 0, 2], xyz[0, 1, 2], xyz[1, 2, 2] = 1e-4, -1e-4, 2e-3
    grad_parity(jgeom.pinhole_projection, tgeom.pinhole_projection, [kmat, xyz],
                atol=2e-6, rtol=2e-6)
    out = tgeom.pinhole_projection(t(kmat), t(xyz))
    assert torch.isfinite(out).all()
    # |z| is clamped to 1e-3 with its sign kept: z / z_safe = +0.1 for both
    assert_close(out[0, :2, 2], np.array([0.1, 0.1], np.float32), 1e-7)


def test_flip_pair():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3, 2)).astype(np.float32)
    dq = (rng.normal(size=(4, 5, 4)).astype(np.float32),
          rng.normal(size=(4, 5, 4)).astype(np.float32))
    tree = {"a": x, "b": (dq, x[:, 0])}
    ref = jdyn.flip_pair(jax.tree.map(jnp.asarray, tree))
    got = tdyn.flip_pair({"a": t(x), "b": ((t(dq[0]), t(dq[1])), t(x[:, 0]))})
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert_close(r, g, 0.0)
    assert np.array_equal(tdyn.flip_pair(t(x))[0].numpy(), x[1])
    one = t(x[:1])
    assert tdyn.flip_pair(one) is one


def test_arap_bone_loss():
    rng = np.random.default_rng(2)
    b1 = rng.normal(size=(25, 3)).astype(np.float32)
    b2 = (b1 + 0.1 * rng.normal(size=(25, 3))).astype(np.float32)
    grad_parity(jskin.arap_bone_loss, tskin.arap_bone_loss, [b1, b2], atol=1e-7, rtol=1e-5)
    xyz = rng.normal(size=(2, 6, 3)).astype(np.float32)
    dq = (rng.normal(size=(2, 1, 5, 4)).astype(np.float32),
          rng.normal(size=(2, 1, 5, 4)).astype(np.float32))
    assert_close(jskin.get_xyz_bone_distance(xyz, dq),
                 tskin.get_xyz_bone_distance(t(xyz), (t(dq[0]), t(dq[1]))), 1e-5, 1e-5)


def test_surf_depth_and_normal_values_and_grads():
    rng = np.random.default_rng(3)
    m, h, w = 2, 12, 10
    depth = rng.uniform(1.0, 3.0, size=(m, h, w)).astype(np.float32)
    median = rng.uniform(1.0, 3.0, size=(m, h, w)).astype(np.float32)
    alpha = rng.uniform(0.05, 1.0, size=(m, h, w)).astype(np.float32)
    intr = np.array([[14.0, 13.0, 5.0, 6.0], [9.0, 11.0, 4.5, 5.5]], np.float32)

    def jfn(d, md, a, k):
        sd, sn = jax.vmap(lambda *x: jdn.surf_depth_and_normal(*x, depth_ratio=0.3))(
            d, md, a, k)
        return jnp.concatenate([sd[..., None], sn], -1)

    def tfn(d, md, a, k):
        sd, sn = tdn.surf_depth_and_normal(d, md, a, k, depth_ratio=0.3)
        return torch.cat([sd[..., None], sn], -1)

    grad_parity(jfn, tfn, [depth, median, alpha, intr], atol=1e-5, rtol=1e-5)
    n = tdn.depth_to_normal_cam(t(depth[0]), t(intr[0]))
    assert n.shape == (h, w, 3)
    assert float(n[0].abs().max()) == float(n[:, -1].abs().max()) == 0.0


def test_image_losses_and_ssim():
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(2, 3, 20, 18)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    grad_parity(jimg.ssim, timg.ssim, [a[0], b[0]], atol=1e-6, rtol=1e-5)
    grad_parity(jax.vmap(jimg.ssim), timg.ssim, [a, b], atol=1e-6, rtol=1e-5)
    for name in ("l1_loss", "mse", "psnr"):
        assert_close(getattr(jimg, name)(a, b), getattr(timg, name)(t(a), t(b)),
                     1e-6, 1e-6, name)


def test_schedules():
    cfg = {"reg_cam_prior_wt": 0.1, "reg_eikonal_wt": 0.01, "reg_skel_prior_wt": 0.1,
           "reg_gauss_mask_wt": 0.01, "lambda_normal": 0.05, "lambda_dist": 0.1}
    for step in (0, 500, 3999, 8000, 8001, 20000):
        assert jsched.progress_schedule(cfg, step) == tsched.progress_schedule(cfg, step)
    for typ in ("linear", "log"):
        assert jsched.interp_wt((0, 10), (1.0, 5.0), 3, typ) == \
            tsched.interp_wt((0, 10), (1.0, 5.0), 3, typ)


@pytest.mark.parametrize("n_px", [256, 300, 1000, 32])
def test_uniform_pixel_subsample(n_px):
    """256: the strided slice; 300, 1000 (stride does not divide the
    width) and 32 (stride = the width): the 2D grid."""
    from vidu4d_tpu.engine.gs4d_trainer import _uniform_pixel_subsample
    from vidu4d_tpu_torch.engine.gs4d_trainer import uniform_pixel_subsample

    x = np.arange(2 * 1024 * 2, dtype=np.float32).reshape(2, 1024, 2)
    ref = _uniform_pixel_subsample(1024, n_px, 32)(jnp.asarray(x))
    got = uniform_pixel_subsample(1024, n_px, 32, "cpu")(t(x))
    assert got.shape == (2, n_px, 2)
    assert_close(ref, got, 0.0)


def _tree_module(tree):
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _tree_module(v))
        else:
            m.register_parameter(k, nn.Parameter(t(v)))
    return m


ADAMW_CASES = {
    # a gradient 100x over the clip norm
    "clip": dict(scale=100.0),
    # NaNs in one leaf on the second update
    "nan": dict(nan_at=1),
    # logscale never gets a gradient (None in the port, zeros in optax):
    # it is still decayed, x10
    "no_grad": dict(no_grad="logscale"),
    # the intrinsics multiplier
    "intrinsics": dict(intrinsics_mult=3.0),
}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_warp_adamw_matches_optax_chain(case):
    kw = ADAMW_CASES[case]
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    params = {"intrinsics": {"base_logfocal": f32(3, 2) + 4.0, "w": f32(4)},
              "warp": {"log_gauss": f32(5, 3), "w": f32(6, 2)},
              "logscale": np.full((1,), -2.3, np.float32), "bias": f32(3)}
    grads = [jax.tree.map(lambda x: f32(*x.shape) * kw.get("scale", 0.3), params)
             for _ in range(3)]
    if "nan_at" in kw:
        grads[kw["nan_at"]]["warp"]["w"][0, 1] = np.nan
    if "no_grad" in kw:
        for g in grads:
            g[kw["no_grad"]] = np.zeros_like(g[kw["no_grad"]])
    hyper = dict(learning_rate=1.0, total_steps=100, num_rounds=10,
                 intrinsics_lr_mult=kw.get("intrinsics_mult", 1.0))

    jp = {"params": jax.tree.map(jnp.asarray, params)}
    opt = joptim.make_stage2_optimizer(jp, **hyper)
    state = opt.init(jp)
    mod = _tree_module(params)
    topt = toptim.WarpAdamW(mod.named_parameters(), **hyper)
    for g in grads:
        upd, state = opt.update({"params": jax.tree.map(jnp.asarray, g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in mod.named_parameters():
            leaf = g
            for part in name.split("."):
                leaf = leaf[part]
            p.grad = None if name == kw.get("no_grad") else t(leaf)
        topt.step()
        ref = convert.flax_to_state_dict(jax.tree.map(np.asarray, jp))
        for name, p in mod.named_parameters():
            assert_close(ref[name], p, 1e-6, 1e-5, name)
    js = convert.warp_adamw_from_optax(jax.tree.map(np.asarray, state), mod, "cpu")
    assert js["count"] == topt.count == 3
    for key in ("mu", "nu"):
        for name in js[key]:
            assert_close(js[key][name], getattr(topt, key)[name], 1e-7, 1e-5, f"{key} {name}")
    if "no_grad" in kw:  # decayed: moved toward 0 although its gradient is 0
        assert float(mod.logscale.detach()) > -2.3 + 1e-4
    for s in range(0, 100, 7):
        sched = joptim.onecycle_linear(1.0, 100, 10)
        assert_close(sched(s), topt.schedule(s), 1e-7, 1e-6, f"schedule {s}")
