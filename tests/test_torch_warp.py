"""Parity of the port's warp stack (camera / intrinsics MLPs, articulation,
skinning field, DQ-skinning warp) with the JAX GaussianDeformer, using flax
parameters converted by vidu4d_tpu_torch.convert.

Tolerances: 256-wide MLP chains in float32 (JAX at "highest" matmul
precision, tests/conftest.py) agree to ~1e-6 relative; values are held to
atol 2e-5 / rtol 1e-4, and parameter gradients to 1e-4 * max |g| (sums over
all surfels in another order).
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
