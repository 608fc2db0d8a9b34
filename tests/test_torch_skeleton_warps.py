"""The port's skeleton articulation and warps (vidu4d_tpu_torch/ops/
geometry.py, models/fields/skeleton.py, skinning.py, warping.py, nvp.py)
against the JAX package's, on the CPU, in float64 (the JAX side under
``jax.enable_x64(True)``).

Each module is the port's, seeded (`flax_default_init_`), with its
parameters converted into the JAX module's flax tree
(`convert.state_dict_to_flax`); inputs are made with numpy from a seed.
Every warp string of `warp_module` runs forward, backward and, where the
warp has one, its SE(3) form, on (2, 5, 3, 3) points at raw frames 1 and
6 of an 8-frame video; the gradients of a fixed random weighting of all
outputs (warped points, (q, t), the skinning aux terms) are compared for
every parameter and for the points. Each JAX function is compiled once.

The JAX package's TimeEmbedding casts the frame time to float32 also in
float64 mode (`embeddings.py:117`), so every time-conditioned output
would carry float32 rounding (measured: up to 6e-6 of a translation's
largest magnitude, 2e-4 of a gradient's); the fixture `float64_time_code`
computes that time in the default float type instead, which is float32
outside float64 mode, so the JAX function is otherwise unchanged.

Tolerances (float64): outputs within VAL_REL (1e-12) of their largest
magnitude; gradients within GRAD_REL (1e-10) of each array's largest
magnitude plus GRAD_FLOOR (1e-13) of the largest over all parameters
(sums run in another order; measured <= 2e-14 and <= 4e-13). Tables, edge
lists and the converter's round trip are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_time_code_in_default_float, n
from vidu4d_tpu.data.frame_info import FrameInfo as JFrameInfo
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields import skeleton as tsk
from vidu4d_tpu_torch.models.fields.mlp import flax_default_init_
from vidu4d_tpu_torch.models.fields.skinning import SkinningField
from vidu4d_tpu_torch.models.fields.warping import ComposedWarp, warp_module
from vidu4d_tpu_torch.ops.geometry import so3_to_exp_map

VAL_REL, GRAD_REL, GRAD_FLOOR = 1e-12, 1e-10, 1e-13
T = 8
FI = FrameInfo(frame_offset=(0, T), frame_mapping=tuple(range(T)), frame_offset_raw=(0, T))
FID = np.array([1, 6])
# every warp class and configuration of `warp_module` ("comp_bob" composes a
# bag of bones, "comp_skel-quad_dense" the quadruped skeleton)
MOTIONS = ["rigid", "dense", "denseSE3", "bob", "bob-nosoft", "bob-sc", "nvp", "skel-human",
           "skel-quad", "comp_skel-quad_dense", "comp_bob"]
# the warps without an SE(3) form (`return_qt` raises NotImplementedError)
NO_QT = {"dense": "DenseWarp", "nvp": "NVPWarp", "comp_skel-quad_dense": "ComposedWarp",
         "comp_bob": "ComposedWarp"}


@pytest.fixture(autouse=True)
def float64_time_code(monkeypatch):
    """The JAX TimeEmbedding's frame time in the default float type (see
    the module docstring)."""
    jax_time_code_in_default_float(monkeypatch)


def _seeded(module, seed=0):
    flax_default_init_(module, torch.Generator().manual_seed(seed))
    return module.double()


def _flat(tree):
    return {"/".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree):
    return {"/".join(getattr(p, "key", str(p)) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jparams(module):
    """The port module's parameters as a float64 flax tree (JAX arrays)."""
    tree = convert.state_dict_to_flax(module.state_dict())
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _close(ref, got, rel, name, floor=0.0):
    ref, got = np.asarray(ref), n(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    assert err <= rel * scale + floor, f"{name}: max|diff| {err} > {rel} * {scale} + {floor}"


def _grads_close(jgrads, module, name):
    """JAX's flax-tree gradients against the port module's ``.grad``s."""
    ref = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(convert.state_dict_to_flax(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in module.named_parameters()}))
    assert ref.keys() == got.keys(), sorted(set(ref) ^ set(got))
    floor = GRAD_FLOOR * max([float(np.abs(v).max()) for v in ref.values()] + [0.0])
    for k in ref:
        _close(ref[k], got[k], GRAD_REL, f"{name} grad {k}", floor)


def _weights(shapes, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


def test_so3_to_exp_map_and_its_gradient_match_jax():
    """Rodrigues on random axis-angles, including ones of norm below eps
    (1e-6), with the gradient of a random weighting. At exactly 0 the
    port's gradient is finite, the JAX package's NaN."""
    from vidu4d_tpu.ops.geometry import so3_to_exp_map as jexp

    rng = np.random.default_rng(0)
    so3 = rng.normal(size=(6, 3))
    so3[1] *= 1e-8
    so3[2] = [3e-7, -2e-7, 1e-7]
    w = rng.normal(size=(6, 3, 3))
    with jax.enable_x64(True):
        rot, g = jax.jit(lambda x: (jexp(x), jax.grad(lambda y: jnp.sum(jexp(y) * w))(x)))(
            jnp.asarray(so3))
        g0 = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jexp(x) * w[0])))(jnp.zeros(3)))
    x = torch.tensor(so3, requires_grad=True)
    got = so3_to_exp_map(x)
    (got * torch.tensor(w)).sum().backward()
    _close(rot, got, VAL_REL, "rotation")
    _close(g, x.grad, VAL_REL, "gradient")
    assert np.isnan(g0).all()
    x0 = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    (so3_to_exp_map(x0) * torch.tensor(w[0])).sum().backward()
    assert torch.isfinite(x0.grad).all()


@pytest.mark.parametrize("skel", ["human", "quad"])
def test_skeleton_tables_match_jax(skel):
    """The rest joints (float32, CV coordinates), the edge table (in its
    order), the mirror indices, the valid edges and the local rest joints
    are the JAX package's, bit for bit."""
    from vidu4d_tpu.models.fields import skeleton as jsk

    jr, je, js = jsk.get_predefined_skeleton(skel)
    tr, te, ts = tsk.get_predefined_skeleton(skel)
    assert tr.dtype == np.float32 and np.array_equal(tr, jr)
    assert list(te.items()) == list(je.items()) and ts == js
    for a, b in zip(jsk.get_valid_edges(je), tsk.get_valid_edges(te)):
        assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(jsk.rest_joints_to_local(jnp.asarray(jr), je)),
                          tsk.rest_joints_to_local(tr, te))


@pytest.mark.parametrize("skel", ["human", "quad"])
def test_fk_and_bone_shift_match_jax(skel):
    """fk_se3 and shift_joints_to_bones(_dq) on random local joints and
    angles (2, B, 3), with gradients."""
    from vidu4d_tpu.models.fields import skeleton as jsk

    rest, edges, _ = tsk.get_predefined_skeleton(skel)
    b = len(rest)
    rng = np.random.default_rng(1)
    local = tsk.rest_joints_to_local(rest, edges)[None].astype(np.float64) \
        * rng.uniform(0.5, 1.5, (2, b, 1))
    so3 = rng.normal(size=(2, b, 3)) * 0.5
    shift = rng.normal(size=3) * 0.01
    w = _weights([(2, b, 4), (2, b, 4), (2, b, 3), (2, b, 4), (2, b, 4)])

    def outs(fk, shift_fn, shift_dq, lo, s, sh):
        dq = fk(lo, s, edges)
        return (*dq, shift_fn(lo, edges), *shift_dq(dq, edges, shift=sh))

    def jfn(lo, s, sh):
        out = outs(jsk.fk_se3, jsk.shift_joints_to_bones, jsk.shift_joints_to_bones_dq,
                   lo, s, sh)
        return sum(jnp.sum(o * wi) for o, wi in zip(out, w)), out

    with jax.enable_x64(True):
        (_, ref), grads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(local), jnp.asarray(so3), jnp.asarray(shift))
    args = [torch.tensor(a, requires_grad=True) for a in (local, so3, shift)]
    got = outs(tsk.fk_se3, tsk.shift_joints_to_bones, tsk.shift_joints_to_bones_dq, *args)
    sum(torch.sum(o * torch.tensor(wi)) for o, wi in zip(got, w)).backward()
    for i, (a, b_) in enumerate(zip(ref, got)):
        _close(a, b_, VAL_REL, f"output {i}")
    for i, (g, a) in enumerate(zip(grads, args)):
        _close(g, a.grad, VAL_REL, f"grad {i}")


@pytest.mark.parametrize("skel", ["human", "quad"])
def test_articulation_skel_mlp_matches_jax(skel):
    """ArticulationSkelMLP: the articulation at frames, with override_so3,
    so3_at, mean_vals, vals_and_mean, the scaled local rest joints per
    instance and skel_prior_loss; the parameters' gradients of a random
    weighting of all of them."""
    from vidu4d_tpu.models.fields.skeleton import ArticulationSkelMLP as JArt

    port = _seeded(tsk.ArticulationSkelMLP(FI, skel_type=skel))
    with torch.no_grad():  # non-zero bone scale and shift
        port.logscale.fill_(0.2)
        port.shift.copy_(torch.tensor([0.01, -0.02, 0.005]))
    b = port.num_se3
    rng = np.random.default_rng(2)
    so3 = rng.normal(size=(2, b, 3)) * 0.3
    w = _weights([(2, b, 4)] * 2 + [(2, b, 4)] * 2 + [(2, b, 3), (1, b, 4), (1, b, 4)]
                 + [(2, b, 4)] * 4 + [(2, b, 3), ()])

    def outs(m, fid, ov):
        return (*m(fid), *m(fid, override_so3=ov), m.so3_at(fid), *m.mean_vals(),
                *m.vals_and_mean(fid)[0], *m.vals_and_mean(fid)[1],
                m.compute_rel_rest_joints(inst_id=fid * 0)[:, :, :], m.skel_prior_loss())

    jmod = JArt(frame_info=JFrameInfo(*FI), skel_type=skel)

    def jfn(p):
        out = jmod.apply(p, method=lambda m: outs(m, jnp.asarray(FID), jnp.asarray(so3)))
        return sum(jnp.sum(o * wi) for o, wi in zip(out, w)), out

    with jax.enable_x64(True):
        (_, ref), grads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(_jparams(port))
    got = outs(port, torch.as_tensor(FID), torch.tensor(so3))
    sum(torch.sum(o * torch.tensor(wi)) for o, wi in zip(got, w)).backward()
    assert len(ref) == len(got)
    for i, (a, b_) in enumerate(zip(ref, got)):
        _close(a, b_, VAL_REL, f"output {i}")
    _grads_close(grads, port, skel)


def test_skinning_field_symmetry_matches_jax():
    """SkinningField with the quad skeleton's mirror indices: get_gauss
    averages each bone's log scales with its mirror's; skin logits, delta
    and gradients."""
    from vidu4d_tpu.models.fields.skinning import SkinningField as JField
    from vidu4d_tpu.ops.quaternion import axis_angle_to_quaternion

    _, _, symm = tsk.get_predefined_skeleton("quad")
    port = _seeded(SkinningField(25, FI, num_inst=1, symm_idx=tuple(symm)))
    with torch.no_grad():
        port.log_gauss.add_(torch.tensor(np.random.default_rng(4).normal(size=(25, 3)) * 0.3))
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(2, 4, 3, 3)) * 0.05
    qr = np.asarray(axis_angle_to_quaternion(jnp.asarray(rng.normal(size=(2, 25, 3)))),
                    np.float64)
    qd = rng.normal(size=(2, 25, 4)) * 0.01
    w = _weights([(25, 3), (2, 4, 3, 25), (2, 4, 3, 25)])
    jmod = JField(num_coords=25, frame_info=JFrameInfo(*FI), num_inst=1,
                  symm_idx=tuple(symm))
    art = lambda a: (a[0][:, None, None], a[1][:, None, None])

    def jfn(p, x):
        g = jmod.apply(p, method=lambda m: m.get_gauss())
        skin, delta = jmod.apply(p, x, art((jnp.asarray(qr), jnp.asarray(qd))),
                                 jnp.asarray(FID), None)
        out = (g, skin, delta)
        return sum(jnp.sum(o * wi) for o, wi in zip(out, w)), out

    with jax.enable_x64(True):
        (_, ref), (grads, gx) = jax.jit(jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True))(_jparams(port), jnp.asarray(xyz))
    x = torch.tensor(xyz, requires_grad=True)
    skin, delta = port(x, art((torch.tensor(qr), torch.tensor(qd))), torch.as_tensor(FID),
                       None)
    got = (port.get_gauss(), skin, delta)
    sum(torch.sum(o * torch.tensor(wi)) for o, wi in zip(got, w)).backward()
    for i, (a, b_) in enumerate(zip(ref, got)):
        _close(a, b_, VAL_REL, f"output {i}")
    _close(gx, x.grad, GRAD_REL, "grad xyz")
    _grads_close(grads, port, "skinning")


def _warp_outputs(warp, xyz, fid, iid, qt):
    """forward, backward, their aux terms and (with ``qt``) both SE(3)
    forms of ``warp`` at the points. A skinning warp's articulation is
    computed once and passed in ``samples_dict``, as the fields pass it."""
    skin = getattr(warp, "skin_warp", warp)
    samples = None
    if hasattr(skin, "articulation"):
        t_art, rest_art = skin.articulation.vals_and_mean(fid)
        samples = {"t_articulation": t_art, "rest_articulation": rest_art}
    fwd, aux_f = warp(xyz, fid, iid, samples_dict=samples)
    bwd, aux_b = warp(xyz, fid, iid, samples_dict=samples, backward=True)
    out = [fwd, bwd] + [aux_f[k] for k in sorted(aux_f)] + [aux_b[k] for k in sorted(aux_b)]
    if qt:
        for backward in (False, True):
            (q, t), _ = warp(xyz, fid, iid, samples_dict=samples, backward=backward,
                             return_qt=True)
            out += [q, t]
    if samples is not None:
        out += [*t_art, *rest_art]
    return out


@pytest.mark.parametrize("motion", MOTIONS)
def test_warp_module_matches_jax(motion):
    """Every ``fg_motion`` of `warp_module`: the same warp class and flax
    tree (names, shapes), forward and backward points, the skinning aux
    terms, (q, t) of both directions where the warp has an SE(3) form (the
    others raise NotImplementedError with JAX's message in both packages),
    and the gradients of a random weighting of all of them with respect to
    every parameter and to the points."""
    from vidu4d_tpu.models.fields.warping import warp_module as jwarp_module

    port = _seeded(warp_module(motion, FI), seed=MOTIONS.index(motion))
    with torch.no_grad():  # every coupling off the identity (its output layer starts at 0)
        for name, p in port.named_parameters():
            if "Dense_2" in name:
                p.copy_(torch.tensor(np.random.default_rng(6).normal(size=p.shape) * 0.3))
    jmod = jwarp_module(motion, JFrameInfo(*FI))
    assert type(jmod).__name__ == type(port).__name__
    rng = np.random.default_rng(7)
    xyz = rng.normal(size=(2, 5, 3, 3)) * 0.06
    iid = np.zeros(2, np.int64)
    qt = motion not in NO_QT
    with jax.enable_x64(True):
        params = _jparams(port)
        shapes = jax.eval_shape(lambda: jmod.init(
            jax.random.PRNGKey(0), method=lambda m: _warp_outputs(
                m, jnp.asarray(xyz), jnp.asarray(FID), jnp.asarray(iid), qt)))
        assert _shapes(shapes) == _shapes(params)
        if not qt:
            with pytest.raises(NotImplementedError, match=f"{NO_QT[motion]} has no SE"):
                jmod.apply(params, jnp.asarray(xyz), jnp.asarray(FID), jnp.asarray(iid),
                           return_qt=True)
        shapes = [o.shape for o in jax.eval_shape(lambda p, x: jmod.apply(
            p, method=lambda m: _warp_outputs(m, x, jnp.asarray(FID), jnp.asarray(iid), qt)),
            params, jnp.asarray(xyz))]
        w = _weights(shapes)

        def jfn(p, x):
            out = jmod.apply(p, method=lambda m: _warp_outputs(
                m, x, jnp.asarray(FID), jnp.asarray(iid), qt))
            return sum(jnp.sum(o * wi) for o, wi in zip(out, w)), out

        (_, ref), (grads, gx) = jax.jit(jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xyz))
    if not qt:
        with pytest.raises(NotImplementedError, match=f"{NO_QT[motion]} has no SE"):
            port(torch.tensor(xyz), torch.as_tensor(FID), torch.as_tensor(iid),
                 return_qt=True)
    x = torch.tensor(xyz, requires_grad=True)
    got = _warp_outputs(port, x, torch.as_tensor(FID), torch.as_tensor(iid), qt)
    assert len(got) == len(ref)
    sum(torch.sum(o * torch.tensor(wi)) for o, wi in zip(got, w)).backward()
    for i, (a, b_) in enumerate(zip(ref, got)):
        _close(a, b_, VAL_REL, f"{motion} output {i}")
    _close(gx, x.grad, GRAD_REL, f"{motion} grad xyz")
    if any(p.requires_grad for p in port.parameters()):
        _grads_close(grads, port, motion)


def test_post_warp_dist2_matches_jax():
    """ComposedWarp.compute_post_warp_dist2 at 64 points of random frames
    (the soft-deform regulariser's call), with gradients."""
    from vidu4d_tpu.models.fields.warping import ComposedWarp as JComposed

    port = _seeded(ComposedWarp(FI, skel_type="quad"))
    jmod = JComposed(frame_info=JFrameInfo(*FI), skel_type="quad")
    rng = np.random.default_rng(8)
    pts = rng.uniform(-0.1, 0.1, (64, 1, 1, 3))
    fid = rng.integers(0, T, 64)
    w = rng.normal(size=(64, 1, 1))
    iid = np.zeros(64, np.int64)

    def jfn(p):
        d = jmod.apply(p, jnp.asarray(pts), jnp.asarray(fid), jnp.asarray(iid),
                       method=jmod.compute_post_warp_dist2)
        return jnp.sum(d * w), d

    with jax.enable_x64(True):
        (_, ref), grads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(_jparams(port))
    got = port.compute_post_warp_dist2(torch.tensor(pts), torch.as_tensor(fid),
                                       torch.as_tensor(iid))
    (got * torch.tensor(w)).sum().backward()
    _close(ref, got, VAL_REL, "dist2")
    _grads_close(grads, port, "post warp")


@pytest.mark.parametrize("motion", ["skel-quad", "denseSE3", "nvp", "comp_skel-human_dense"])
def test_converter_round_trip(motion):
    """state dict -> flax -> state dict is bitwise for each new tree; the
    NVP couplings keep flax's Dense_0 .. Dense_2 (Dense_0 the first hidden
    layer, of 2 + 32 inputs) while a Head's Dense_0 / Dense_1 become out /
    hidden."""
    port = _seeded(warp_module(motion, FI)).float()
    sd = port.state_dict()
    tree = convert.state_dict_to_flax(sd)
    back = convert.flax_to_state_dict(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    flat = _flat(tree)
    if motion == "nvp":
        assert {k.split("/")[1] for k in flat if "couplings" in k} == {
            f"couplings_{i}" for i in range(6)}
        assert flat["params/couplings_3/Dense_0/kernel"].shape == (34, 32)
        assert flat["params/couplings_3/Dense_2/kernel"].shape == (32, 2)
    if motion.startswith("skel") or motion.startswith("comp"):
        prefix = "params/articulation" if motion.startswith("skel") else \
            "params/skin_warp/articulation"
        for leaf in ("so3_head/Dense_0/kernel", "so3_head/Dense_1/kernel", "logscale",
                     "shift", "log_bone_len/mlp/linear_final/kernel"):
            assert f"{prefix}/{leaf}" in flat, leaf
