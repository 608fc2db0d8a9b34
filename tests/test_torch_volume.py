"""The port's volume rendering (vidu4d_tpu_torch/ops/volume.py) and the
Stage-2 geometry helpers against the JAX package's, on the CPU.

Tolerances (float32, the same numpy inputs): forward values within 1e-5 of
the output's largest magnitude (`assert_close_to_max`), gradients within
1e-4 of the largest gradient of the same input (sums run in another
order) plus 1e-6 of the largest gradient of any input (render_pixel's
per-field mask x / (x + 1e-6) leaves its density a gradient of ~1e-5 that
is all rounding); `linspace01` and the aabb helpers exactly; `sample_grid`
within 1e-7 (XLA fuses a * (1 - s) + b * s into a multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close_to_max, n, t
from vidu4d_tpu.ops import geometry as jgeom
from vidu4d_tpu.ops import volume as jvol
from vidu4d_tpu_torch.ops import geometry as tgeom
from vidu4d_tpu_torch.ops import volume as tvol

M, N, D = 2, 5, 7
FWD, GRAD = 1e-5, 1e-4


def _rays(rng):
    hxy = np.concatenate([rng.uniform(0, 32, (M, N, 2)), np.ones((M, N, 1))], -1)
    kinv = np.stack([np.linalg.inv(np.array([[40.0 + 5 * i, 0, 16], [0, 42.0, 15], [0, 0, 1]]))
                     for i in range(M)])
    near_far = np.stack([rng.uniform(0.5, 1.0, M), rng.uniform(2.0, 3.0, M)], -1)
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(hxy), f32(kinv), f32(near_far)


def _value_and_grads(jfn, tfn, inputs, seed=0):
    """Values and the gradients of sum(out * w) (w fixed random) of a JAX
    function and its port returning one array each."""
    jout = jfn(*[jnp.asarray(x) for x in inputs])
    w = np.random.default_rng(seed).normal(size=np.shape(jout)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs])
    targs = [t(x, requires_grad=True) for x in inputs]
    tout = tfn(*targs)
    (tout * t(w)).sum().backward()
    assert_close_to_max(jout, tout, FWD, "value")
    for i, (g, a) in enumerate(zip(jg, targs)):
        assert_close_to_max(g, a.grad if a.grad is not None else torch.zeros_like(a), GRAD,
                            f"grad {i}")


@pytest.mark.parametrize("n_pts", [2, 7, 64, 128])
def test_linspace01_is_jax_linspace(n_pts):
    assert np.array_equal(n(tgeom.linspace01(n_pts)),
                          np.asarray(jnp.linspace(0.0, 1.0, n_pts, dtype=jnp.float32)))


@pytest.mark.parametrize("override", [False, True])
def test_sample_cam_rays_matches_jax(override):
    """All four outputs (points, unit directions, deltas, depths), values
    and gradients, with uniform depths and with a depth override."""
    rng = np.random.default_rng(1)
    hxy, kinv, nf = _rays(rng)
    depth = np.sort(rng.uniform(0.5, 3.0, (M, N, D, 1)), axis=2).astype(np.float32)

    def cat(m, outs):
        return (jnp.concatenate if m is jnp else torch.cat)(list(outs), -1)

    if override:
        jfn = lambda h, k, f, d: cat(jnp, jvol.sample_cam_rays(h, k, f, depth=d))
        tfn = lambda h, k, f, d: cat(torch, tvol.sample_cam_rays(h, k, f, depth=d))
        _value_and_grads(jfn, tfn, [hxy, kinv, nf, depth])
    else:
        jfn = lambda h, k, f: cat(jnp, jvol.sample_cam_rays(h, k, f, n_depth=D))
        tfn = lambda h, k, f: cat(torch, tvol.sample_cam_rays(h, k, f, n_depth=D))
        _value_and_grads(jfn, tfn, [hxy, kinv, nf])


def test_compute_weights_matches_jax():
    rng = np.random.default_rng(2)
    dens = rng.uniform(0, 5, (M, N, D, 1)).astype(np.float32)
    deltas = rng.uniform(0.01, 0.3, (M, N, D, 1)).astype(np.float32)
    for i in range(2):
        _value_and_grads(lambda a, b: jvol.compute_weights(a, b)[i],
                         lambda a, b: tvol.compute_weights(a, b)[i], [dens, deltas], seed=i)


def _field_dict(rng):
    f = lambda *s: rng.normal(size=(M, N, D) + s).astype(np.float32)
    flow = f(3)
    flow[..., 2] = (flow[..., 2] > 0).astype(np.float32)
    return {"density": np.abs(f(1)) * 3, "rgb": f(3), "normal": f(3), "flow": flow,
            "cyc_dist": np.abs(f(1)), "xyz_cam": f(3), "skin_entropy": np.abs(f(1)),
            "density_fg": np.abs(f(1)), "vis": f(1), "eikonal": np.abs(f(1)),
            "delta_skin": np.abs(f(1)), "gauss_density": np.abs(f(1)), "xyz": f(3)}


def test_integrate_and_render_pixel_match_jax():
    """Every output of integrate and render_pixel (KEY_SKIP, KEY_FREEZE,
    flow, normal, per-field masks, vis, eikonal, delta_skin, gauss_mask),
    values and the gradients of every input; the port's extra "vis_norm"
    is the mean transmittance that divides "vis"."""
    rng = np.random.default_rng(3)
    fd = _field_dict(rng)
    deltas = rng.uniform(0.01, 0.3, (M, N, D, 1)).astype(np.float32)
    names = sorted(fd)
    jout = jvol.render_pixel({k: jnp.asarray(fd[k]) for k in names}, jnp.asarray(deltas))
    keys = sorted(jout)
    tin = {k: t(fd[k], requires_grad=True) for k in names}
    tdel = t(deltas, requires_grad=True)
    tout = tvol.render_pixel(tin, tdel)
    assert set(tout) == set(keys) | {"vis_norm"}
    w = {k: np.random.default_rng(7).normal(size=np.shape(jout[k])).astype(np.float32)
         for k in keys}

    def jloss(d, dl):
        out = jvol.render_pixel(d, dl)
        return sum(jnp.sum(out[k] * w[k]) for k in keys)

    jg, jgd = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(fd[k]) for k in names},
                                               jnp.asarray(deltas))
    sum(torch.sum(tout[k] * t(w[k])) for k in keys).backward()
    for k in keys:
        assert_close_to_max(jout[k], tout[k], FWD, k)
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max()) for g in [*jg.values(), jgd])
    for k in names:
        got = tin[k].grad if tin[k].grad is not None else torch.zeros_like(tin[k])
        err = float(np.abs(n(got) - np.asarray(jg[k])).max())
        assert err <= GRAD * float(np.abs(np.asarray(jg[k])).max()) + floor, (k, err)
    assert_close_to_max(jgd, tdel.grad, GRAD, "grad deltas")


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det, monkeypatch):
    """Inverse-CDF samples, values and gradients with respect to the bins
    and the weights; det=False with the port's draws handed to JAX."""
    rng = np.random.default_rng(4)
    r, s, k = 6, 9, 11
    bins = np.sort(rng.uniform(0.5, 3.0, (r, s - 1)), axis=1).astype(np.float32)
    weights = np.abs(rng.normal(size=(r, s - 2))).astype(np.float32)
    weights[0] = 0.0  # a ray with no weight: uniform pdf
    weights[1, 2:] = 0.0  # all the weight in the first bins
    if det:
        jfn = lambda b, w: jvol.sample_pdf(b, w, k, det=True)
        tfn = lambda b, w: tvol.sample_pdf(b, w, k, det=True)
    else:
        u = torch.rand((r, k), generator=torch.Generator().manual_seed(3))
        monkeypatch.setattr(jvol.jax.random, "uniform",
                            lambda key, shape, dtype=None: jnp.asarray(n(u)))
        jfn = lambda b, w: jvol.sample_pdf(b, w, k, rng=jax.random.PRNGKey(0))
        tfn = lambda b, w: tvol.sample_pdf(b, w, k,
                                           generator=torch.Generator().manual_seed(3))
    _value_and_grads(jfn, tfn, [bins, weights])


def test_geometry_helpers_match_jax():
    """get_near_far, extend_aabb, check_inside_aabb, sample_grid and
    points_aabb."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 0.1
    rt = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    rt[:, :3, 3] = rng.uniform(-0.1, 0.1, (3, 3))
    rt[:, 2, 3] += np.array([0.3, 0.5, 0.05], np.float32)  # the last camera inside
    _value_and_grads(lambda p, r: jgeom.get_near_far(p, r, tol_fac=1.5),
                     lambda p, r: tgeom.get_near_far(p, r, tol_fac=1.5), [pts, rt])
    aabb = np.array([[-0.1, -0.2, -0.05], [0.12, 0.1, 0.3]], np.float32)
    assert np.array_equal(np.asarray(jgeom.extend_aabb(jnp.asarray(aabb), 0.25)),
                          n(tgeom.extend_aabb(t(aabb), 0.25)))
    assert np.array_equal(np.asarray(jgeom.check_inside_aabb(jnp.asarray(pts),
                                                             jnp.asarray(aabb))),
                          n(tgeom.check_inside_aabb(t(pts), t(aabb))))
    np.testing.assert_allclose(n(tgeom.sample_grid(t(aabb), 5)),
                               np.asarray(jgeom.sample_grid(jnp.asarray(aabb), 5)), atol=1e-7)
    assert np.array_equal(np.asarray(jgeom.points_aabb(jnp.asarray(pts))),
                          n(tgeom.points_aabb(t(pts))))
