"""Parity of the port's leaf math (vidu4d_tpu_torch.ops) with the JAX package.

Tolerances: float32 elementwise math evaluated by two libraries agrees to
a few ulps (atol/rtol 1e-6); reductions and matmuls (einsum blends, knn)
sum in another order (1e-5).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, t
from vidu4d_tpu.ops import geometry as jgeom
from vidu4d_tpu.ops import knn as jknn
from vidu4d_tpu.ops import numerics as jnum
from vidu4d_tpu.ops import quaternion as jq
from vidu4d_tpu.ops import sh as jsh
from vidu4d_tpu_torch.ops import geometry as tgeom
from vidu4d_tpu_torch.ops import knn as tknn
from vidu4d_tpu_torch.ops import numerics as tnum
from vidu4d_tpu_torch.ops import quaternion as tq
from vidu4d_tpu_torch.ops import sh as tsh


def _grad_parity(jfn, tfn, inputs, atol=1e-6, rtol=1e-5):
    """Value and gradient (of sum(out * w), w fixed random) parity."""
    rng = np.random.default_rng(0)
    jout = jfn(*[jnp.asarray(x) for x in inputs])
    w = rng.normal(size=np.shape(jout)).astype(np.float32)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(inputs)))
    )(*[jnp.asarray(x) for x in inputs])
    targs = [t(x, requires_grad=True) for x in inputs]
    tout = tfn(*targs)
    assert_close(jout, tout, atol, rtol, "value")
    (tout * t(w)).sum().backward()
    for i, (jg, ta) in enumerate(zip(jgrads, targs)):
        got = ta.grad if ta.grad is not None else torch.zeros_like(ta)  # unused input
        assert_close(jg, got, atol, rtol, f"grad {i}")


def test_safe_norm_parity_and_zero_subgradient():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    x[2] = 0.0
    _grad_parity(lambda a: jnp.sum(jnum.safe_norm(a, axis=-1)),
                 lambda a: tnum.safe_norm(a, dim=-1).sum(), [x])
    z = torch.zeros(4, 3, requires_grad=True)
    tnum.safe_norm(z, dim=-1).sum().backward()
    assert torch.equal(z.grad, torch.zeros(4, 3))
    # safe_normalize at 0: finite (1/eps) gradients, as in JAX
    zj = jax.grad(lambda a: jnp.sum(jnum.safe_normalize(a)))(jnp.zeros((2, 3)))
    z = torch.zeros(2, 3, requires_grad=True)
    tnum.safe_normalize(z).sum().backward()
    assert torch.isfinite(z.grad).all()
    assert_close(zj, z.grad, 0.0, 1e-6)


@pytest.mark.parametrize("name", [
    "quaternion_mul", "quaternion_apply", "quaternion_translation_inverse",
    "axis_angle_to_quaternion", "quaternion_to_matrix",
    "dual_quaternion_mul", "dual_quaternion_apply",
])
def test_quaternion_ops(name):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q2 = rng.normal(size=(5, 4)).astype(np.float32)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    unit = lambda m, a: a / m.sqrt(m.sum(a * a, -1, keepdims=True)) \
        if m is jnp else a / torch.sqrt((a * a).sum(-1, keepdim=True))
    cases = {
        "quaternion_mul": ([q, q2], lambda m: m.quaternion_mul),
        "quaternion_apply": ([q, v], lambda m: lambda a, b: m.quaternion_apply(
            unit(jnp if m is jq else torch, a), b)),
        "quaternion_translation_inverse": ([q, v], lambda m: lambda a, b: (
            lambda r: r[1])(m.quaternion_translation_inverse(
                unit(jnp if m is jq else torch, a), b))),
        "axis_angle_to_quaternion": ([v], lambda m: m.axis_angle_to_quaternion),
        "quaternion_to_matrix": ([q], lambda m: m.quaternion_to_matrix),
        "dual_quaternion_mul": ([q, q2, v, q], lambda m: lambda a, b, c, d: (
            lambda r: r[0] + r[1])(m.dual_quaternion_mul((a, b), (c[..., :1] * d, d)))),
        "dual_quaternion_apply": ([q, q2, v], lambda m: lambda a, b, c:
                                  m.dual_quaternion_apply(
                                      (unit(jnp if m is jq else torch, a), b), c)),
    }
    inputs, get = cases[name]
    _grad_parity(get(jq), get(tq), inputs, atol=2e-6, rtol=2e-5)


def test_dual_quaternion_skinning_values_and_grads():
    rng = np.random.default_rng(3)
    m, p, b = 2, 64, 5
    qr = rng.normal(size=(m, b, 4)).astype(np.float32)
    qr /= np.linalg.norm(qr, axis=-1, keepdims=True)
    qd = 0.1 * rng.normal(size=(m, b, 4)).astype(np.float32)
    pts = rng.normal(size=(m, p, 1, 3)).astype(np.float32)
    logits = rng.normal(size=(m, p, 1, b)).astype(np.float32)

    def jfn(qr, qd, pts, logits):
        q, tr = jq.dual_quaternion_skinning((qr, qd), pts, jax.nn.softmax(logits, -1),
                                            return_qt=True)
        return jnp.concatenate([q, tr], -1)

    def tfn(qr, qd, pts, logits):
        q, tr = tq.dual_quaternion_skinning((qr, qd), pts, torch.softmax(logits, -1),
                                            return_qt=True)
        return torch.cat([q, tr], -1)

    _grad_parity(jfn, tfn, [qr, qd, pts, logits], atol=1e-5, rtol=1e-5)
    warped_j = jq.dual_quaternion_skinning((qr, qd), pts, jax.nn.softmax(logits, -1))
    warped_t = tq.dual_quaternion_skinning((t(qr), t(qd)), t(pts),
                                           torch.softmax(t(logits), -1))
    assert_close(warped_j, warped_t, 1e-5, 1e-5)


def test_geometry_intrinsics():
    rng = np.random.default_rng(4)
    k = np.abs(rng.normal(size=(3, 4))).astype(np.float32) + 0.5
    for jf, tf in ((jgeom.K2mat, tgeom.K2mat), (jgeom.K2inv, tgeom.K2inv)):
        _grad_parity(jf, tf, [k])
    kmat = np.asarray(jgeom.K2mat(k))
    assert_close(jgeom.mat2K(kmat), tgeom.mat2K(t(kmat)), 0.0)
    assert_close(jgeom.Kmatinv(kmat), tgeom.Kmatinv(t(kmat)), 1e-6, 1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_color(deg):
    rng = np.random.default_rng(5 + deg)
    k = (deg + 1) ** 2
    sh = rng.normal(size=(2, 40, k, 3)).astype(np.float32) * 0.5
    means = rng.normal(size=(2, 40, 3)).astype(np.float32)
    cam = np.zeros(3, np.float32)
    _grad_parity(lambda s, m: jsh.eval_sh_color(deg, s, m, jnp.asarray(cam)),
                 lambda s, m: tsh.eval_sh_color(deg, s, m, t(cam)),
                 [sh, means], atol=2e-6, rtol=1e-5)


def test_mean_knn_sq_dist():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    ref = jknn.mean_knn_sq_dist(jnp.asarray(pts), k=3, chunk_size=256, cand_chunk=512)
    got = tknn.mean_knn_sq_dist(t(pts), k=3, chunk_size=128)
    assert_close(ref, got, 1e-5, 1e-4)


def test_port_imports_no_jax():
    """Every module of the port imports without jax (in a fresh process)."""
    code = (
        "import pkgutil, sys, importlib, vidu4d_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vidu4d_tpu_torch.__path__, "
        "'vidu4d_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 20, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
