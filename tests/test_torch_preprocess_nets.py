"""Stage 1's nets in the port against the JAX package, on the CPU, with the
shipped weights (`vidu4d_tpu/weights/*.npz`) read through the converter:
RAFT-small (and its correlation pyramid and lookup), `compute_flow_pairs`
with either backend, DepthNet through `depth_from_net`, FeatNet and its
sampler, the HOG + colour descriptor, `extract_video_features` with both
backbones, and the golden scores of tests/test_golden_weights.py.

Everything runs in float32, as the JAX nets hard-code (`raft.py:79`,
`:96-97`, `:186-193`); the bounds cover convolutions that sum in another
order:
* RAFT 2e-4 px (measured 2.3e-5 .. 4.1e-5 on flows up to 7.4 px after the
  12 GRU iterations), the correlation and its lookup 1e-5;
* `compute_flow_pairs`: flow as RAFT's, LK 1e-3 px; the occlusion channel
  (a 1.5 px threshold on the cycle) differs at <= 0.5% of the pixels;
* DepthNet's depth 1e-4 (in [0.5, 4]); FeatNet and its samples 1e-5; the
  HOG + colour features 1e-5 of their max;
* the backbone features 1e-5; `pca_project` fed JAX's own backbone
  features gives JAX's float16 output exactly;
* golden scores within 1e-3 of JAX's (EPE in px, accuracies as shares).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_close, assert_close_to_max, n, t
from vidu4d_tpu.preprocess import depth as jdepth
from vidu4d_tpu.preprocess import features as jfeat
from vidu4d_tpu.preprocess import featnet as jfn
from vidu4d_tpu.preprocess import flow as jflow
from vidu4d_tpu.preprocess import raft as jraft
from vidu4d_tpu.preprocess.depthnet import DepthNet as JDepthNet
from vidu4d_tpu.preprocess.depthnet import load_weights as jload_depthnet
from vidu4d_tpu_torch.preprocess import depth as tdepth
from vidu4d_tpu_torch.preprocess import features as tfeat
from vidu4d_tpu_torch.preprocess import featnet as tfn
from vidu4d_tpu_torch.preprocess import flow as tflow
from vidu4d_tpu_torch.preprocess import raft as traft
from vidu4d_tpu_torch.preprocess.depthnet import load_depthnet

HERE = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(os.path.dirname(HERE), "vidu4d_tpu", "weights")
RAFT_TOL = 2e-4
OCC_DIFF_SHARE = 5e-3


@pytest.fixture(scope="module")
def raft():
    """(jitted JAX apply, JAX params, the port's RaftSmall)."""
    params = jraft.load_weights(os.path.join(WEIGHTS, "raft_small_synthetic.npz"))
    return jax.jit(jraft.RaftSmall().apply), params, traft.load_raft(device="cpu")


def _pair(rng, h, w, shift=2):
    base = rng.uniform(size=(2, h + 8, w + 8, 3)).astype(np.float32)
    base = np.asarray(jax.vmap(jax.vmap(jflow._blur, in_axes=-1, out_axes=-1))(
        jnp.asarray(base)))
    return base[:, 4:4 + h, 4:4 + w], base[:, 4:4 + h, 4 - shift:4 - shift + w]


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)])
def test_raft_matches_jax(raft, hw):
    """48 x 64: the 1/8 grid of 6 rows leaves the pyramid's last level
    empty, which reads 0 in both."""
    japply, params, model = raft
    a, b = _pair(np.random.default_rng(0), *hw)
    ref = japply(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = model(t(a).permute(0, 3, 1, 2), t(b).permute(0, 3, 1, 2))
    assert got.shape == ref.shape
    assert_close(ref, got, RAFT_TOL)


def test_corr_pyramid_and_lookup_match_jax():
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    f2 = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    coords = rng.uniform(-2, 14, size=(2, 8, 12, 2)).astype(np.float32)
    jpyr = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    tpyr = traft.build_corr_pyramid(t(f1).permute(0, 3, 1, 2), t(f2).permute(0, 3, 1, 2))
    for a, b in zip(jpyr, tpyr):
        assert_close(a, b, 1e-5)
    assert_close(jraft.lookup_corr(jpyr, jnp.asarray(coords)),
                 traft.lookup_corr(tpyr, t(coords)).permute(0, 2, 3, 1), 1e-5)


@pytest.mark.parametrize("backend", ["raft", "lk"])
def test_compute_flow_pairs_matches_jax(raft, backend, monkeypatch):
    if backend == "lk":
        monkeypatch.setenv("VIDU4D_FLOW_BACKEND", "lk")
    else:
        japply, params, _ = raft
        monkeypatch.setitem(jflow._RAFT_STATE, "tried", True)
        monkeypatch.setitem(jflow._RAFT_STATE, "model", type("M", (), {
            "apply": staticmethod(japply)}))
        monkeypatch.setitem(jflow._RAFT_STATE, "params", params)
    rng = np.random.default_rng(2)
    tex = rng.uniform(size=(48, 80, 3)).astype(np.float32)
    tex = np.asarray(jax.vmap(jflow._blur, in_axes=-1, out_axes=-1)(jnp.asarray(tex)))
    frames = np.stack([tex[8:40, 8 + 2 * i:40 + 2 * i] for i in range(4)])
    stats = {}
    got = tflow.compute_flow_pairs(t(frames), 2, stats=stats)
    assert stats["flow"] == backend
    ref = jflow.compute_flow_pairs(jnp.asarray(frames), 2)
    for r, g in zip(ref, got):
        assert_close(np.asarray(r)[..., :2], g[..., :2], RAFT_TOL if backend == "raft" else 1e-3)
        share = float(np.mean(np.asarray(r)[..., 2] != n(g)[..., 2]))
        assert share <= OCC_DIFF_SHARE, share


def test_raft_weights_file_that_does_not_load_raises(tmp_path, monkeypatch):
    """JAX falls back to LK when the RAFT weights fail to load; the port
    raises. Without a weights file the port, like JAX, takes LK."""
    bad = tmp_path / "raft.npz"
    bad.write_bytes(b"not an npz")
    monkeypatch.setenv("VIDU4D_RAFT_NPZ", str(bad))
    frames = torch.rand(2, 16, 16, 3)
    with pytest.raises(ValueError):
        tflow.compute_flow_pairs(frames, 1)
    monkeypatch.setenv("VIDU4D_RAFT_NPZ", str(tmp_path / "missing.npz"))
    stats = {}
    tflow.compute_flow_pairs(frames, 1, stats=stats)
    assert stats["flow"] == "lk"


def test_depth_from_net_matches_jax():
    """40 x 56 is edge-padded to 48 x 64 for the four stride-2 stages."""
    params = jload_depthnet(os.path.join(WEIGHTS, "depthnet_synthetic.npz"))
    frames = np.random.default_rng(3).uniform(size=(3, 40, 56, 3)).astype(np.float32)
    ref = jdepth.depth_from_net(jnp.asarray(frames), JDepthNet(), params)
    got = tdepth.depth_from_net(t(frames), load_depthnet(device="cpu"), chunk=2)
    assert got.shape == (3, 40, 56)
    assert_close(ref, got, 1e-4)
    stats = {}
    out = tdepth.estimate_depth(frames, device="cpu", stats=stats)
    assert stats["depth"] == "depthnet" and out.dtype == np.float16


def test_featnet_and_sample_features_match_jax():
    params = jfn.load_weights(os.path.join(WEIGHTS, "featnet_synthetic.npz"))
    x = np.random.default_rng(4).uniform(size=(2, 48, 64, 3)).astype(np.float32)
    ref = jfn.FeatNet().apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tfn.load_featnet(device="cpu")(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(ref, got, 1e-5)
    xy = np.random.default_rng(5).uniform(0, 60, size=(50, 2)).astype(np.float32)
    xy[:, 1] *= 46 / 60
    assert_close(jfn.sample_features(ref[0], jnp.asarray(xy)),
                 tfn.sample_features(got[0], t(xy)), 1e-5)


def test_hog_color_features_matches_jax():
    img = np.random.default_rng(6).uniform(size=(48, 40, 3)).astype(np.float32)
    ref = jfeat.hog_color_features(jnp.asarray(img), out_res=32)
    got = tfeat.hog_color_features(t(img), out_res=32)
    assert got.shape == (32, 32, 33)
    assert_close_to_max(ref, got, 1e-5)


def _jax_backbone(frames, backbone, out_res):
    """JAX's per-frame backbone features, as `extract_video_features`
    computes them (`features.py:114-129`)."""
    if backbone == "featnet":
        model, params = jfeat._featnet_backend()

        @jax.jit
        def fn(f):
            d = model.apply(params, f[None])[0]
            return jax.image.resize(d, (out_res, out_res, d.shape[-1]), "bilinear")
    else:
        fn = jax.jit(lambda f: jfeat.hog_color_features(f, out_res=out_res))
    return np.stack([np.asarray(fn(jnp.asarray(f, jnp.float32))) for f in frames])


@pytest.mark.parametrize("backbone", ["featnet", "hog"])
def test_extract_video_features_matches_jax(backbone):
    rng = np.random.default_rng(7)
    frames = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    masks = np.zeros((3, 32, 32), np.float32)
    masks[:, 6:26, 8:24] = 1.0
    ref = jfeat.extract_video_features(frames, masks=masks, backbone=backbone)
    jb = _jax_backbone(frames, backbone, 112)
    model = tfeat._featnet_backend("cpu") if backbone == "featnet" else None
    tb = tfeat.backbone_features(t(frames), model, 112)
    assert_close(jb, tb, 1e-5)
    np.testing.assert_array_equal(tfeat.pca_project(jb, masks), ref)
    stats = {}
    got = tfeat.extract_video_features(frames, masks=masks, backbone=backbone, device="cpu",
                                       stats=stats)
    assert stats["features"] == backbone and got.shape == ref.shape == (3, 112, 112, 16)
    assert got.dtype == np.float16
    # outside the masks both are 0; inside, unit vectors (the basis is
    # fit on features 1e-5 apart, so it may turn within near-equal
    # singular values: compared above through pca_project)
    off = np.all(got == 0, axis=-1)
    np.testing.assert_array_equal(off, np.all(ref == 0, axis=-1))
    norms = np.linalg.norm(got.astype(np.float32), axis=-1)[~off]
    assert np.abs(norms - 1).max() < 2e-3


def _match_accuracy(f1, f2, xy1, xy2, radius_px=4.0):
    """`featnet.match_accuracy` (`featnet.py:94`) on the port's features."""
    a = n(tfn.sample_features(f1, t(xy1)))
    b = n(tfn.sample_features(f2, t(xy2)))
    a /= np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-6)
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-6)
    best = np.argmax(a @ b.T, axis=1)
    return float((np.linalg.norm(xy2[best] - xy2, axis=-1) <= radius_px).mean())


@pytest.mark.parametrize("net", ["raft", "featnet", "depthnet"])
def test_golden_scores_match_jax(raft, net):
    """The golden scores of tests/test_golden_weights.py (RAFT EPE on the
    seed-777 warps, FeatNet match accuracy and DepthNet order accuracy on
    tests/golden/*.npz), the port's within 1e-3 of JAX's."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    if net == "raft":
        from train_raft import make_batch

        japply, params, model = raft
        img1, img2, gt = make_batch(np.random.default_rng(777), res=64, batch=2, max_disp=12.0)
        ref = japply(params, img1, img2)
        with torch.no_grad():
            got = model(t(img1).permute(0, 3, 1, 2), t(img2).permute(0, 3, 1, 2))
        epe = lambda p: float(np.mean(np.sqrt(np.sum((n(p) - np.asarray(gt)) ** 2, -1) + 1e-12)))
        scores = epe(ref), epe(got)
        assert scores[1] < 4.0
    elif net == "featnet":
        pairs = np.load(os.path.join(HERE, "golden", "featnet_pairs.npz"))
        params = jfn.load_weights(os.path.join(WEIGHTS, "featnet_synthetic.npz"))
        model = tfn.load_featnet(device="cpu")
        jaccs, taccs = [], []
        for i1, i2, xy1, xy2 in zip(pairs["img1"], pairs["img2"], pairs["xy1"], pairs["xy2"]):
            f1 = jfn.FeatNet().apply(params, jnp.asarray(i1)[None])[0]
            f2 = jfn.FeatNet().apply(params, jnp.asarray(i2)[None])[0]
            jaccs.append(jfn.match_accuracy(f1, f2, xy1, xy2))
            with torch.no_grad():
                g = model(t(np.stack([i1, i2])).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            taccs.append(_match_accuracy(g[0], g[1], xy1, xy2))
        scores = float(np.mean(jaccs)), float(np.mean(taccs))
        assert scores[1] > 0.95
    else:
        from train_depthnet import order_accuracy

        scenes = np.load(os.path.join(HERE, "golden", "depthnet_scenes.npz"))
        params = jload_depthnet(os.path.join(WEIGHTS, "depthnet_synthetic.npz"))
        model = load_depthnet(device="cpu")
        jrng, trng = np.random.default_rng(777), np.random.default_rng(777)
        jaccs, taccs = [], []
        for rgb, depth in zip(scenes["rgb"], scenes["depth"]):
            jaccs.append(order_accuracy(
                np.asarray(JDepthNet().apply(params, jnp.asarray(rgb)[None])[0]), depth, jrng))
            with torch.no_grad():
                disp = model(t(rgb)[None].permute(0, 3, 1, 2))[0]
            taccs.append(order_accuracy(n(disp), depth, trng))
        scores = float(np.mean(jaccs)), float(np.mean(taccs))
        assert scores[1] > 0.70
    assert abs(scores[0] - scores[1]) <= 1e-3, scores
