"""ROADMAP C1 on the CPU: the splat's 2D low-pass term far from the frame's
origin.

The Pallas kernel expands rho2d = FIS ((cx - px)^2 + (cy - py)^2) into a
polynomial in absolute pixel coordinates whose float32 terms reach
FIS (px^2 + py^2), ~1e6 at 512^2, and cancel; the port's kernels and their
plain versions evaluate the splat-centred form, as the JAX package's
reference and tiles path do (`compositing.py`). The scene: one 512^2
frame, 16 small, distant splats (`chip_smoke.c1_scene`: depth 20-40,
0.5-2 px across, so the 2D branch decides much of their response) in its
far corner, x and y in [400, 504], from a numpy seed.

* forward: the port's plain tile rasterizer in float32 against the port's
  naive oracle in float64 on the float64 projection. Alpha within 1/255
  everywhere (chip_smoke.py's [c1] gate); colour within 5e-4 + 1e-3 |ref|
  where the reference's alpha is > 1/255 (tests/test_torch_rasterize.py's
  bound against the naive paths);
* the JAX package's naive path on the same float32 inputs against the
  port's plain tile rasterizer, within that module's 5e-4 / 1e-3;
* the gradient of a colour + alpha loss (fixed random pixel weights) with
  respect to the means against the float64 naive path's: within GRAD_REL
  of the largest float64 gradient. On this scene the centred form is at
  3.2e-4 of it (float32 rounding through the projection and the
  compositing), the absolute-coordinate polynomial at 1.0e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from tests.torch_parity import assert_close, assert_close_to_max, n
from vidu4d_tpu.ops.rasterize import common as jc
from vidu4d_tpu.ops.rasterize.reference import rasterize_naive_from_projection as jnaive
from vidu4d_tpu_torch.ops.rasterize import common as tc
from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
from vidu4d_tpu_torch.ops.rasterize.reference import rasterize_naive_from_projection as tnaive

RES = 512
# the far-corner scene; tests/test_torch_tile_split.py's card test draws the same
SCENE = dict(n=16, width=RES, height=RES, box=(400, 504, 400, 504))
SMOOTH = ("color", "depth", "alpha", "normal", "distortion", "final_t")
GRAD_REL = 1e-3
ALPHA_TOL = 1.0 / 255.0


def _scene():
    return chip_smoke.c1_scene(np.random.default_rng(0), **SCENE)


def _frame(p):
    return tc.SplatProjection(*[x[0] for x in p])


def _render(scene, dtype, means=None):
    """The port's float32 plain tile rasterizer (dtype float32) or its
    float64 naive oracle (float64) on the scene's projection."""
    _, _, _, opac, colors, _ = scene
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    proj = chip_smoke.c1_project(scene, dtype, "cpu", means)
    bg = t(np.zeros(3))
    if dtype == torch.float32:
        out = tb.rasterize_batch(proj, t(colors)[None], t(opac), bg, RES, RES)
        return type(out)(*[f[0] for f in out])
    return tnaive(_frame(proj), t(colors), t(opac), bg, RES, RES)


def test_plain_rasterizer_matches_float64_oracle_far_from_origin():
    scene = _scene()
    got = _render(scene, torch.float32)
    ref = _render(scene, torch.float64)
    covered = n(ref.alpha) > 1.0 / 255.0
    assert covered.sum() > 50  # the splats are in view
    assert float(np.abs(n(got.alpha) - n(ref.alpha)).max()) <= ALPHA_TOL
    assert_close(n(ref.color)[covered], n(got.color)[covered], 5e-4, 1e-3, "color")


def test_plain_rasterizer_matches_jax_naive_far_from_origin():
    scene = _scene()
    means, quats, scales, opac, colors, intr = (np.asarray(x, np.float32) for x in scene)
    jp = jc.project_splats(jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
                           jnp.eye(4, dtype=jnp.float32), jnp.asarray(intr[0]))
    jo = jax.jit(jnaive, static_argnums=(4, 5))(
        jp, jnp.asarray(colors), jnp.asarray(opac), jnp.zeros(3, jnp.float32), RES, RES)
    got = _render(scene, torch.float32)
    for f in SMOOTH:
        assert_close(getattr(jo, f), getattr(got, f), 5e-4, 1e-3, f)


def test_plain_rasterizer_means_gradient_matches_float64_oracle():
    scene = _scene()
    w = np.random.default_rng(1).normal(size=(RES, RES, 4))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        means = torch.tensor(scene[0], dtype=dtype, requires_grad=True)
        out = _render(scene, dtype, means)
        wt = torch.as_tensor(w, dtype=dtype)
        loss = (out.color * wt[..., :3]).sum() + (out.alpha * wt[..., 3]).sum()
        loss.backward()
        grads[dtype] = means.grad
    assert float(grads[torch.float64].abs().max()) > 0
    assert_close_to_max(grads[torch.float64], grads[torch.float32], GRAD_REL, "means")
