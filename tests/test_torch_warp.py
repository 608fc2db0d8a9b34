"""Parity of the port's warp stack (camera / intrinsics MLPs, articulation,
skinning field, DQ-skinning warp) with the JAX GaussianDeformer, using flax
parameters converted by vidu4d_tpu_torch.convert.

Tolerances: 256-wide MLP chains in float32 (JAX at "highest" matmul
precision, tests/conftest.py) agree to ~1e-6 relative; values are held to
atol 2e-5 / rtol 1e-4, and parameter gradients to 1e-4 * max |g| (sums over
all surfels in another order). The warp losses (backward warp, cycle, flow,
matching) chain the warp with its inverse: their parameter gradients are
held to 3e-4 * max |g| of the parameter + 1e-5 * max |g| over all
parameters, because terms that cancel (the camera's in the cycle, true
value 0) leave only rounding (measured: 1.7e-4 of the parameter's max on
the articulation head, 3e-5 absolute on the cancelling camera terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, assert_close_to_max, t
from vidu4d_tpu.data.frame_info import FrameInfo
from vidu4d_tpu.models.fields import embeddings as jemb
from vidu4d_tpu.models.gaussian.deformable import GaussianDeformer as JDeformer
from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.models.fields import embeddings as temb
from vidu4d_tpu_torch.models.gaussian.deformable import GaussianDeformer as TDeformer

FI = FrameInfo.from_video_lengths([8, 6])


def _inputs(p=48):
    rng = np.random.default_rng(0)
    batch = {
        "frameid": np.array([3, 9], np.int32),
        "dataid": np.array([0, 1], np.int32),
        "crop2raw": np.array([[2.0, 2.0, 0.0, 0.0], [1.5, 1.5, 1.0, 2.0]], np.float32),
        "hxy": rng.normal(size=(2, 16, 3)).astype(np.float32),
    }
    xyz = (rng.normal(size=(p, 3)) * 0.05).astype(np.float32)
    rot = rng.normal(size=(p, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    return batch, xyz, rot


@pytest.fixture(scope="module")
def deformers():
    batch, xyz, rot = _inputs()
    jd = JDeformer(frame_info=FI, fg_motion="bob")

    def fwd(mdl, batch, xyz, rot):
        s = mdl.get_samples(batch)
        out = mdl.warp_surfels(xyz, rot, s)
        mdl.background()
        return out

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jd.init(jax.random.PRNGKey(0), jb, jnp.asarray(xyz), jnp.asarray(rot),
                     method=fwd)
    # non-trivial values for the zero-initialised leaves
    p = dict(params["params"])
    rng = np.random.default_rng(1)
    p["bg_color"] = jnp.asarray(rng.normal(size=3), jnp.float32)
    cam = dict(p["camera_mlp"])
    cam["base_quat"] = jnp.asarray(rng.normal(size=(2, 4)), jnp.float32)
    p["camera_mlp"] = cam
    intr = dict(p["intrinsics"])
    intr["base_logfocal"] = jnp.asarray(rng.normal(size=(2, 2)) * 0.1 + 3.0, jnp.float32)
    intr["base_ppoint"] = jnp.asarray(rng.normal(size=(2, 2)) + 16.0, jnp.float32)
    p["intrinsics"] = intr
    params = {"params": p}
    td = TDeformer(FI, fg_motion="bob")
    convert.load_flax_params_(td, jax.tree.map(np.asarray, params))
    return jd, params, td, batch, xyz, rot


def test_time_embedding_and_pos_embed():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    for freqs in (-1, 0, 4):
        assert_close(jemb.pos_embed(jnp.asarray(x), freqs),
                     temb.pos_embed(t(x), freqs), 1e-6, 1e-6)
    je = jemb.TimeEmbedding(num_freq_t=3, frame_info=FI, out_channels=16)
    fid = jnp.asarray([0, 5, 9, 13])
    params = je.init(jax.random.PRNGKey(3), fid)
    te = temb.TimeEmbedding(3, FI, out_channels=16)
    convert.load_flax_params_(te, jax.tree.map(np.asarray, params))
    assert_close(je.apply(params, fid), te(t(np.asarray(fid))), 1e-6, 1e-5)
    assert_close(je.apply(params, method=je.mean_embedding), te.mean_embedding(),
                 1e-6, 1e-5)


def test_convert_covers_every_parameter(deformers):
    jd, params, td, *_ = deformers
    sd = convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
    assert set(sd) == {k for k, _ in td.named_parameters()}
    w = dict(td.named_parameters())["camera_mlp.trans_head.out.weight"]
    k = params["params"]["camera_mlp"]["trans_head"]["Dense_0"]["kernel"]
    assert_close(np.asarray(k).T, w, 0.0)


def test_get_samples(deformers):
    jd, params, td, batch, *_ = deformers
    js = jax.jit(lambda p, b: jd.apply(p, b, method=jd.get_samples))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        ts = td.get_samples({k: t(v) for k, v in batch.items()})
    for key in ("field2cam", "t_articulation", "rest_articulation"):
        for a, b in zip(js[key], ts[key]):
            assert_close(a, b, 2e-5, 1e-4, key)
    assert_close(js["Kinv"], ts["Kinv"], 1e-7, 1e-5, "Kinv")


def test_warp_surfels_values_and_grads(deformers):
    jd, params, td, batch, xyz, rot = deformers
    rng = np.random.default_rng(4)
    w_x = rng.normal(size=(2, xyz.shape[0], 3)).astype(np.float32)
    w_r = rng.normal(size=(2, xyz.shape[0], 4)).astype(np.float32)
    w_a = rng.normal(size=(2, xyz.shape[0], 1)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params, xyz, rot):
        s = jd.apply(params, jb, method=jd.get_samples)
        xc, rc, aux = jd.apply(params, xyz, rot, s, method=jd.warp_surfels)
        bg = jd.apply(params, method=jd.background)
        scalar = (jnp.sum(xc * w_x) + jnp.sum(rc * w_r) + jnp.sum(bg)
                  + jnp.sum(aux["skin_entropy"] * w_a) + jnp.sum(aux["delta_skin"] * w_a))
        return scalar, (xc, rc, aux)

    (jval, (jxc, jrc, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(xyz), jnp.asarray(rot))

    txyz, trot = t(xyz, True), t(rot, True)
    s = td.get_samples({k: t(v) for k, v in batch.items()})
    txc, trc, taux = td.warp_surfels(txyz, trot, s)
    tval = ((txc * t(w_x)).sum() + (trc * t(w_r)).sum() + td.background().sum()
            + (taux["skin_entropy"] * t(w_a)).sum() + (taux["delta_skin"] * t(w_a)).sum())
    tval.backward()

    assert_close(jxc, txc, 2e-5, 1e-4, "xyz_cam")
    assert_close(jrc, trc, 2e-5, 1e-4, "rot_cam")
    for k in ("skin_entropy", "delta_skin"):
        assert_close(jaux[k], taux[k], 2e-5, 1e-4, k)
    assert_close(jval, tval, 1e-4, 1e-5, "scalar")
    assert_close_to_max(jg[1], txyz.grad, 1e-4, "d xyz")
    assert_close_to_max(jg[2], trot.grad, 1e-4, "d rot")
    jgrads = convert.flax_to_state_dict(jax.tree.map(np.asarray, jg[0]))
    for name, prm in td.named_parameters():
        got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        if float(jgrads[name].abs().max()) == 0.0:
            assert float(got.abs().max()) == 0.0, name
        else:
            assert_close_to_max(jgrads[name], got, 1e-4, name)


def _warp_loss_inputs(xyz):
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 12, 16)).astype(np.float32)
    rfeat = rng.normal(size=(xyz.shape[0], 16)).astype(np.float32)
    rfeat /= np.linalg.norm(rfeat, axis=-1, keepdims=True)
    return feat, rfeat


def _cat(m, parts):
    return m.concatenate(parts, -1) if m is jnp else torch.cat(parts, -1)


# each body: (module, samples, xyz, rot, feat, rfeat, array namespace) -> (M, N, C)
WARP_LOSS_BODIES = {
    "backward_warp": lambda d, s, xyz, rot, feat, rf, m: (lambda out: _cat(m, [
        out[0][0], out[0][1], out[1]["skin_entropy"], out[1]["delta_skin"]]))(
        d.warp(d.warp_surfels(xyz, rot, s)[0][:, :, None], s["frame_id"], s["inst_id"],
               samples_dict=s, backward=True, return_qt=True)),
    "cycle_loss": lambda d, s, xyz, rot, feat, rf, m: (lambda c: _cat(m, [
        c["cyc_dist"], c["xyz_cycled"], c["skin_entropy"], c["delta_skin"]]))(
        d.cycle_loss(d.warp_surfels(xyz, rot, s)[0][:, ::3], xyz[::3], s)),
    "flow_surfels_from_canonical": lambda d, s, xyz, rot, feat, rf, m: (
        lambda xc: d.flow_surfels(xc, s, (m.broadcast_to(xyz[None], xc.shape)
                                          if m is jnp else xyz[None].expand_as(xc))))(
        d.warp_surfels(xyz, rot, s)[0]),
    "flow_surfels_backward_warp": lambda d, s, xyz, rot, feat, rf, m: d.flow_surfels(
        d.warp_surfels(xyz, rot, s)[0], s),
    "global_match": lambda d, s, xyz, rot, feat, rf, m: d.global_match(
        feat, rf, xyz, num_candidates=16),
    "forward_project": lambda d, s, xyz, rot, feat, rf, m: _cat(m, list(d.forward_project(
        d.global_match(feat, rf, xyz, num_candidates=16), s))),
}


@pytest.mark.parametrize("name", list(WARP_LOSS_BODIES))
def test_deformer_warp_losses_values_and_grads(deformers, name):
    """The backward warp, cycle loss, pair flow (both branches), global
    match and forward projection: values and gradients w.r.t. the
    parameters, the canonical points and the registration features."""
    jd, params, td, batch, xyz, rot = deformers
    body = WARP_LOSS_BODIES[name]
    feat, rfeat = _warp_loss_inputs(xyz)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(params, xyz, rfeat):
        return jd.apply(params, xyz, rfeat, method=lambda mdl, x, rf: body(
            mdl, mdl.get_samples(jb), x, jnp.asarray(rot), jnp.asarray(feat), rf, jnp))

    jout = jax.jit(jfn)(params, jnp.asarray(xyz), jnp.asarray(rfeat))
    w = np.random.default_rng(6).normal(size=jout.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=(0, 1, 2)))(
        params, jnp.asarray(xyz), jnp.asarray(rfeat))

    txyz, trf = t(xyz, True), t(rfeat, True)
    for prm in td.parameters():
        prm.grad = None
    s = td.get_samples({k: t(v) for k, v in batch.items()})
    tout = body(td, s, txyz, t(rot), t(feat), trf, torch)
    (tout * t(w)).sum().backward()

    scale = float(np.abs(np.asarray(jout)).max())
    assert_close(jout, tout, 2e-5 * max(scale, 1.0), 1e-4, name)
    assert_close_to_max(jg[1], txyz.grad, 1e-4, "d xyz")
    if float(np.abs(np.asarray(jg[2])).max()) > 0:
        assert_close_to_max(jg[2], trf.grad, 1e-4, "d regist_feat")
    jgrads = convert.flax_to_state_dict(jax.tree.map(np.asarray, jg[0]))
    g_all = max(float(g.abs().max()) for g in jgrads.values())
    nonzero = 0
    for pname, prm in td.named_parameters():
        got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        ref = jgrads[pname]
        if float(ref.abs().max()) == 0.0:
            assert float(got.abs().max()) == 0.0, pname
            continue
        err = float((got - ref).abs().max())
        assert err <= 3e-4 * float(ref.abs().max()) + 1e-5 * g_all, (pname, err)
        nonzero += 1
    assert nonzero > 0
