"""The port's Stage-2 field and model (vidu4d_tpu_torch/models/fields/
dyn_nerf.py, engine/model.py) against the JAX package's, on the CPU.

Each configuration builds the port's seeded DvrModel (field depth 2, width
32, 8 train samples, 128 eval samples; its intrinsics at the prior and
its camera fitted to the prior, so that the rays cross the field) and converts its parameters into the JAX
model's flax tree (`convert.dvr_flax_from_state_dict`); both run on the
same batch (2 pairs x 12 pixels) and field state.

Tolerances. Float32 forward outputs (the train path) within 1e-4 of each
output's largest magnitude, and float32 loss terms within 1e-4 relative:
the canonical points of the two packages differ by float32 rounding
(~5e-7), the 10-band positional encoding multiplies a position error by up
to 2^9, the flow divides by depth. The eval path and the gradients are held
in float64 (the JAX side under ``jax.enable_x64``, the same draws): eval
outputs within 1e-4 of their largest magnitude (measured <= 4e-5: a 1e-10
difference of the cameras moves an importance sample by up to 1e-4 of the
far plane, below), each parameter's gradient within 1e-5 of its largest
magnitude plus 1e-9 of the largest of any parameter (measured <= 2.1e-6:
the JAX model keeps a few float32 steps in float64 mode, its matching
scores' ``preferred_element_type`` and its camera prior, and the camera
gradients amplify them). In float32 both are ill-conditioned at these
weights: an eval sample in a bin that holds ~eps of the CDF moves by the
CDF's rounding over eps (the density there by ~4e-3 relative), and the
camera and intrinsics gradients move by 4-15% in float64 under a 1e-6
relative perturbation of the parameters (the colour field's 12-band
encoding), so the two packages' float32 gradients differ by up to ~15%
and cannot carry a tight bound.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from vidu4d_tpu.data.frame_info import FrameInfo as JFrameInfo
from vidu4d_tpu.engine.model import DvrModel as JDvrModel
from vidu4d_tpu.engine.optim import lr_multiplier_tree
from vidu4d_tpu.engine.schedules import progress_schedule as jprogress
from vidu4d_tpu.models.fields.dyn_nerf import FieldState as JFieldState
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.engine.model import DvrModel
from vidu4d_tpu_torch.engine.optim import lr_multiplier
from vidu4d_tpu_torch.engine.trainer import LOSS_DEFAULTS
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
from vidu4d_tpu_torch.models.fields.time_mlp import (
    camera_prior_loss,
    fit_to_prior,
    init_camera_base_params,
    init_intrinsics_base_params,
)

T, M, NPX, RES = 8, 4, 12, 32
FWD, LOSS_RTOL, EVAL64, GRAD, GRAD_FLOOR = 1e-4, 1e-4, 1e-4, 1e-5, 1e-9
CONFIG = {**LOSS_DEFAULTS, "train_res": RES}
# (fg_motion, rgb_timefree, rgb_dirfree)
# the README recipe (bob, --rgb_timefree --rgb_dirfree), and the rigid field
# with the appearance code and view directions
CONFIGS = {"bob-recipe": ("bob", True, True), "rigid": ("rigid", False, False)}


def _batch(rng):
    hxy = np.concatenate([rng.uniform(0, RES, (M, NPX, 2)), np.ones((M, NPX, 1))], -1)
    mask = (rng.uniform(size=(M, NPX, 1)) > 0.4).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    return {
        "rgb": f32(rng.uniform(size=(M, NPX, 3))), "mask": mask,
        "depth": f32(rng.uniform(1, 3, (M, NPX, 1))), "flow": f32(rng.normal(size=(M, NPX, 2))),
        "flow_uct": f32(rng.uniform(size=(M, NPX, 1))), "vis2d": np.ones((M, NPX, 1), np.float32),
        "crop2raw": np.tile(np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), (M, 1)),
        "dataid": np.zeros((M,), np.int32), "frameid_sub": np.array([0, 1, 4, 5], np.int32),
        "frameid": np.array([0, 1, 4, 5], np.int32), "is_detected": np.ones((M,), np.float32),
        "hxy": f32(hxy), "feature": f32(rng.normal(size=(M, NPX, 16))),
    }


def _state():
    """A field state around the unit sphere of radius 0.12 seen from 0.3."""
    aabb = np.array([[-0.12, -0.11, -0.13], [0.12, 0.125, 0.11]], np.float32)
    nf = np.tile(np.array([[0.16, 0.45]], np.float32), (T, 1))
    nf[3] = [0.2, 0.4]
    proxy = np.random.default_rng(9).normal(size=(64, 3)).astype(np.float32) * 0.1
    return aabb, nf, proxy


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    """(name, port DvrModel, JAX DvrModel, its params, batch (numpy), state
    (numpy), intrinsics prior) for one configuration."""
    fg_motion, timefree, dirfree = CONFIGS[request.param]
    fi = FrameInfo(frame_offset=(0, T), frame_mapping=tuple(range(T)),
                   frame_offset_raw=(0, T))
    rt = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    rt[:, 2, 3] = 3.0
    rt[:, 0, 3] = np.linspace(-0.2, 0.2, T)
    rt_scaled = rt.copy()
    rt_scaled[:, :3, 3] *= 0.1
    kw = dict(rgb_timefree=timefree, rgb_dirfree=dirfree, train_depth_samples=8,
              field_depth=2, field_width=32)
    torch.manual_seed(0)
    port = DvrModel(fi, fg_motion=fg_motion, rtmat_prior=rt_scaled, device="cpu",
                    generator=torch.Generator().manual_seed(0), **kw)
    intr = np.tile(np.array([[40.0, 40.0, 16.0, 16.0]], np.float32), (T, 1))
    cam = port.fields["fg"].camera_mlp
    init_camera_base_params(cam, rt_scaled, fi)
    prior = torch.as_tensor(rt_scaled)
    fit_to_prior(lambda: camera_prior_loss(cam, prior), cam.parameters(),
                 termination_loss=1e-4)
    init_intrinsics_base_params(port.intrinsics, intr, fi)
    jmodel = JDvrModel(frame_info=JFrameInfo(*fi), fg_motion=fg_motion,
                       intrinsics_prior=tuple(map(tuple, intr)),
                       rtmat_prior=tuple(map(tuple, rt_scaled.reshape(T, -1))),
                       train_res=RES, **kw)
    params = jax.tree.map(jnp.asarray, convert.dvr_flax_from_state_dict(port.state_dict()))
    return request.param, port, jmodel, params, _batch(np.random.default_rng(1)), _state()


def _jstate(state):
    return {"fg": JFieldState(*[jnp.asarray(a) for a in state])}


def _tstate(state):
    return {"fg": FieldState(*[t(a) for a in state])}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(ref, got, rel, name):
    ref, got = np.asarray(ref), n(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    assert err <= rel * scale + 1e-7, f"{name}: max|diff| {err} > {rel} * {scale}"


def test_param_tree_matches_jax(models):
    """The converted parameters have the JAX model's names and shapes, and
    the optimiser's per-parameter learning-rate multiplier is JAX's on
    every leaf."""
    _, port, jmodel, params, batch, state = models
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), _jbatch(batch), _jstate(state), CONFIG, jprogress(CONFIG, 0),
        jax.random.PRNGKey(1), method=jmodel.loss))
    flat = lambda tree: {"/".join(getattr(p, "key", str(p)) for p in path): leaf.shape
                         for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(shapes) == flat(params)
    jm = jax.tree_util.tree_flatten_with_path(lr_multiplier_tree(params, intrinsics_mult=3.0))[0]
    want = {"/".join(getattr(p, "key", str(p)) for p in path): float(v) for path, v in jm}
    mult_tree = convert.dvr_flax_from_state_dict(
        {k: torch.full((1,), lr_multiplier(k, intrinsics_mult=3.0))
         for k, _ in port.named_parameters()})
    got = {"/".join(getattr(p, "key", str(p)) for p in path): float(v[0]) for path, v in
           jax.tree_util.tree_flatten_with_path(mult_tree)[0]}
    assert got == want


def _query(jmodel, params, batch, state, train):
    def run(mdl):
        kinv = mdl.compute_kinv(batch)
        field = mdl.fields["fg"]
        samples = field.get_samples(kinv, batch, state["fg"])
        return field.query_field(samples, state["fg"], train=train,
                                 alpha=0.6 if train else None, flow_thresh=RES)
    return jmodel.apply(params, method=run)


def _f64(tree):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in tree.items()}


@pytest.mark.parametrize("train", [True, False])
def test_query_field_matches_jax(models, train):
    """DynNeRF.query_field on the train path in float32 (every output: rgb,
    density, vis, flow, cycle, skinning terms, eikonal, features, matching
    and reprojection, gauss density, depth) and on the eval path (two-pass
    importance sampling, aabb mask) in float64: its samples move with the
    CDF's rounding over eps (see the module docstring)."""
    _, port, jmodel, params, batch, state = models
    tol = FWD if train else EVAL64
    if train:
        jfeat, jdeltas, jaux = jax.jit(lambda p: _query(
            jmodel, p, _jbatch(batch), _jstate(state), True))(params)
        model, tb, ts = port, _tbatch(batch), _tstate(state)
    else:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
            jfeat, jdeltas, jaux = jax.tree.map(np.asarray, jax.jit(lambda p: _query(
                jmodel, p, _jbatch(_f64(batch)),
                {"fg": JFieldState(*[jnp.asarray(a, jnp.float64) for a in state])},
                False))(p64))
        model, tb = copy.deepcopy(port).double(), _tbatch(_f64(batch))
        ts = {"fg": FieldState(*[torch.as_tensor(a, dtype=torch.float64) for a in state])}
    with torch.set_grad_enabled(train):
        field = model.fields["fg"]
        samples = field.get_samples(model.compute_kinv(tb), tb, ts["fg"])
        tfeat, tdeltas, taux = field.query_field(samples, ts["fg"], train=train,
                                                 alpha=0.6 if train else None,
                                                 flow_thresh=RES)
    assert set(tfeat) == set(jfeat) and set(taux) == set(jaux)
    _close(jdeltas, tdeltas, tol, "deltas")
    for k in jfeat:
        _close(jfeat[k], tfeat[k], tol, k)
    for k in jaux:
        _close(jaux[k], taux[k], tol, k)


def _jax_draws(rng_key, num_inst=1):
    """The draws of the JAX DvrModel.reg_losses for ``rng_key``
    (`model.py:169`), as the port's reg_draws dict."""
    k_vis, k_gauss, _, k_inst = jax.random.split(rng_key, 4)
    return {"vis": torch.as_tensor(np.asarray(jax.random.uniform(k_vis, (512, 3)))),
            "inst": torch.as_tensor(np.asarray(jax.random.randint(k_inst, (512,), 0, num_inst))),
            "gauss": torch.as_tensor(np.asarray(jax.random.uniform(k_gauss, (2048, 3))))}


def _jloss(jmodel, batch, state, weights, key):
    def fn(p):
        ld, _ = jmodel.apply(p, batch, state, CONFIG, weights, key, method=jmodel.loss)
        return sum(jax.tree.leaves(ld)), ld
    return fn


def test_loss_and_grads_match_jax(models):
    """DvrModel.loss at step 0 (alpha 0.6), JAX's draws injected: every
    weighted term in float32, and every parameter's gradient of their sum
    in float64."""
    name, port, jmodel, params, batch, state = models
    weights = jprogress(CONFIG, 0)
    key = jax.random.PRNGKey(3)
    jtot, jld = jax.jit(_jloss(jmodel, _jbatch(batch), _jstate(state), weights, key))(params)
    tld, _ = port.loss(_tbatch(batch), _tstate(state), CONFIG, weights, _jax_draws(key))
    assert set(tld) == set(jld), sorted(set(tld) ^ set(jld))
    for k in jld:
        np.testing.assert_allclose(float(tld[k]), float(jld[k]), rtol=LOSS_RTOL, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(sum(tld.values())), float(jtot), rtol=LOSS_RTOL)

    f64 = _f64
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        state64 = {"fg": JFieldState(*[jnp.asarray(a, jnp.float64) for a in state])}
        (jtot, _), jgrads = jax.jit(jax.value_and_grad(
            _jloss(jmodel, _jbatch(f64(batch)), state64, weights, key), has_aux=True))(p64)
        draws = _jax_draws(key)
        jgrads = jax.tree.map(np.asarray, jgrads)
    model = copy.deepcopy(port).double()
    tld, _ = model.loss(_tbatch(f64(batch)),
                        {"fg": FieldState(*[torch.as_tensor(a, dtype=torch.float64)
                                            for a in state])}, CONFIG, weights, draws)
    total = sum(tld.values())
    total.backward()
    np.testing.assert_allclose(float(total), float(jtot), rtol=1e-7)
    got = convert.dvr_flax_from_state_dict(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in model.named_parameters()})
    flat = lambda tree: {"/".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ref, got = flat(jgrads), flat(got)
    assert ref.keys() == got.keys()
    floor = GRAD_FLOOR * max(float(np.abs(v).max()) for v in ref.values())
    for k in ref:
        assert got[k].dtype == np.float64, k
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= GRAD * float(np.abs(ref[k]).max()) + floor, (name, k, err,
                                                                  float(np.abs(ref[k]).max()))


def test_normal_and_gauss_density_match_jax(models):
    """compute_normal (eikonal and camera-space normals through the
    backward warp), gauss_skin_consistency_density and get_gauss_sdf."""
    name, port, jmodel, params, batch, state = models
    rng = np.random.default_rng(5)
    xyz_cam = (rng.normal(size=(M, 3, 2, 3)) * 0.05 + [0, 0, 0.3]).astype(np.float32)
    dirs = rng.normal(size=(M, 3, 2, 3)).astype(np.float32)
    pts = (rng.normal(size=(50, 3)) * 0.08).astype(np.float32)

    def run(mdl):
        kinv = mdl.compute_kinv(_jbatch(batch))
        field = mdl.fields["fg"]
        s = field.get_samples(kinv, _jbatch(batch), _jstate(state)["fg"])
        out = field.compute_normal(jnp.asarray(xyz_cam), jnp.asarray(dirs), s["field2cam"],
                                   s["frame_id"], s["inst_id"], s, alpha=0.6)
        if name == "bob":
            out = out + field.gauss_skin_consistency_density(jnp.asarray(pts), alpha=0.6) \
                + (field.warp.get_gauss_sdf(jnp.asarray(pts), bias=0.1),)
        return out

    ref = jax.jit(lambda p: jmodel.apply(p, method=run))(params)
    tb = _tbatch(batch)
    field = port.fields["fg"]
    s = field.get_samples(port.compute_kinv(tb), tb, _tstate(state)["fg"])
    got = field.compute_normal(t(xyz_cam), t(dirs), s["field2cam"], s["frame_id"],
                               s["inst_id"], s, alpha=0.6)
    if name == "bob":
        got = got + field.gauss_skin_consistency_density(t(pts), alpha=0.6) \
            + (field.warp.get_gauss_sdf(t(pts), bias=0.1),)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        _close(a, b, FWD, f"output {i}")
