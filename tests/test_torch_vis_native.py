"""The port's last small modules against the JAX package's:
vidu4d_tpu_torch/data/native.py (the ctypes gather over csrc/batch_sampler.cpp,
built into vidu4d_tpu_torch/_build/) with the native read path of
data/vidloader.py, and vidu4d_tpu_torch/utils/vis.py. Every comparison is
bitwise: both are the same numpy / C++ code on the same inputs (the
float16 -> float32 conversion is exact)."""

import os

import numpy as np
import pytest

from tests.helpers import make_fake_db
from vidu4d_tpu_torch.data import native
from vidu4d_tpu_torch.utils import vis as tvis


def _gather_inputs(dtype):
    rng = np.random.default_rng(0)
    src = rng.uniform(size=(10, 32, 48, 3)).astype(dtype)
    fids = rng.integers(0, 10, size=64).astype(np.int32)
    xy = np.stack([rng.integers(0, 48, size=(64, 16)), rng.integers(0, 32, size=(64, 16))],
                  axis=-1).astype(np.int32)
    return src, fids, xy


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_native_gather_matches_numpy_bitwise(dtype):
    """gather_pixels (native, 1 and 8 threads) equals numpy's fancy-index
    gather bitwise, and the JAX package's gather."""
    from vidu4d_tpu.data import native as jnative

    src, fids, xy = _gather_inputs(dtype)
    want = src[fids[:, None], xy[..., 1], xy[..., 0]].astype(np.float32)
    assert native.load_library() is not None
    for threads in (1, 8):
        got = native.gather_pixels(src, fids, xy, n_threads=threads)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(jnative.gather_pixels(src, fids, xy), want)
    # a 3-D source gains its channel axis
    got = native.gather_pixels(src[..., 0], fids, xy)
    assert np.array_equal(got, want[..., :1])


def test_library_builds_into_the_build_dir():
    """The library is compiled into vidu4d_tpu_torch/_build/ (named by the
    source's hash), not next to the source."""
    lib = native.load_library()
    path = lib._name
    assert os.path.dirname(path) == str(native.BUILD_DIR)
    assert os.path.basename(path).startswith("libbatch_sampler_")
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == \
        "vidu4d_tpu_torch"
    assert native.SOURCE.is_file()


def test_read_raw_native_matches_numpy_and_jax(tmp_path, monkeypatch):
    """read_raw of sampled pixels through the native gather (4 calls: the
    flow, rgb, mask and depth maps) equals the numpy path
    (VIDU4D_NATIVE_SAMPLER=0) and the JAX package's read_raw, every key,
    bitwise; with the variable set the native gather is not called."""
    from vidu4d_tpu.data import data_utils as jdata
    from vidu4d_tpu_torch.data import data_utils as tdata

    db = make_fake_db(tmp_path, num_vids=1, T=8, H=16, W=16)
    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop", "train_res": 16,
            "pixels_per_image": 8}
    ds = tdata.build_datasets(opts)[0]
    jds = jdata.build_datasets(opts)[0]
    xy = np.random.default_rng(0).integers(0, 16, size=(8, 2)).astype(np.int64)
    calls = []
    gather = native.gather_pixels
    monkeypatch.setattr(native, "gather_pixels", lambda *a, **k: calls.append(1) or gather(*a, **k))
    for idx, delta in ((2, 1), (4, 2), (5, -1), (7, -2)):
        n_calls = len(calls)
        out_native = ds.read_raw(idx, delta, xy)
        assert len(calls) == n_calls + 4
        out_jax = jds.read_raw(idx, delta, xy)
        with monkeypatch.context() as m:
            m.setenv("VIDU4D_NATIVE_SAMPLER", "0")
            m.setattr(native, "gather_pixels", lambda *a, **k: pytest.fail("native called"))
            out_numpy = ds.read_raw(idx, delta, xy)
        assert set(out_native) == set(out_numpy) == set(out_jax)
        for k in out_numpy:
            for other in (out_native, out_jax):
                a, b = np.asarray(out_numpy[k]), np.asarray(other[k])
                assert a.dtype == b.dtype and np.array_equal(a, b), (idx, delta, k)


TAGS = ["rgb", "rendered", "feature", "feature_nopca", "depth", "mask", "vis2d", "normal",
        "flow", "other"]


@pytest.mark.parametrize("tag", TAGS)
def test_img2color_matches_jax(tag):
    """img2color of every tag (a PCA function for "feature"; 3-D and 2-D
    inputs where the tag takes one channel) equals JAX's bitwise."""
    from vidu4d_tpu.utils import vis as jvis

    rng = np.random.default_rng(1)
    img = rng.normal(size=(12, 10, 4)).astype(np.float32)
    pca = (lambda x: x[..., :3] * 2.0) if tag == "feature" else None
    name = "feature" if tag == "feature_nopca" else tag
    for x in (img, img[..., 0]) if tag in ("depth", "mask", "vis2d", "other") else (img,):
        a, b = jvis.img2color(name, x, pca), tvis.img2color(name, x, pca)
        assert a.dtype == b.dtype and np.array_equal(a, b), tag
    h = rng.uniform(size=(5, 7)).astype(np.float32)
    assert np.array_equal(jvis._hsv_to_rgb(h, h, h), tvis._hsv_to_rgb(h, h, h))


def test_image_grid_and_camera_meshes_match_jax():
    """make_image_grid (a partial last row, the empty list),
    camera_frustum_mesh and draw_cams (subsampled beyond 200 cameras) equal
    JAX's bitwise."""
    from vidu4d_tpu.utils import vis as jvis

    rng = np.random.default_rng(2)
    images = [rng.uniform(size=(6, 5, 4)).astype(np.float32) for _ in range(7)]
    for cols in (3, 4):
        assert np.array_equal(jvis.make_image_grid(images, cols),
                              tvis.make_image_grid(images, cols))
    assert np.array_equal(jvis.make_image_grid([]), tvis.make_image_grid([]))
    for n in (3, 450):
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        rt = np.tile(np.eye(4), (n, 1, 1))
        rt[:, :3, :3], rt[:, :3, 3] = q, rng.normal(size=(n, 3))
        (va, fa), (vb, fb) = jvis.draw_cams(rt, 0.1), tvis.draw_cams(rt, 0.1)
        assert np.array_equal(va, vb) and np.array_equal(fa, fb) and va.dtype == vb.dtype
        assert len(fa) == 6 * len(rt[::max(1, n // 200)])
        for x, y in zip(jvis.camera_frustum_mesh(rt[0]), tvis.camera_frustum_mesh(rt[0])):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("name", ["depthnet", "featnet", "raft"])
def test_weight_writers_are_atomic_with_numpy_bytes(name, tmp_path, monkeypatch):
    """save_weights of the three Stage-1 nets writes numpy's bytes
    (np.savez, np.savez_compressed for RAFT) through a temporary file moved
    into place: a write that dies leaves the earlier file as it was and no
    temporary file."""
    from vidu4d_tpu_torch.convert import flax_conv_net_flat
    from vidu4d_tpu_torch.preprocess import depthnet, featnet, raft

    weights = os.path.join(os.path.dirname(os.path.dirname(__file__)), "vidu4d_tpu", "weights")
    mod = {"depthnet": depthnet, "featnet": featnet, "raft": raft}[name]
    shipped = {"depthnet": "depthnet_synthetic.npz", "featnet": "featnet_synthetic.npz",
               "raft": "raft_small_synthetic.npz"}[name]
    load = {"depthnet": depthnet.load_depthnet, "featnet": featnet.load_featnet,
            "raft": raft.load_raft}[name]
    model = load(os.path.join(weights, shipped), device="cpu")
    save = ((lambda p: raft.save_weights(model, p)) if name == "raft"
            else (lambda p: mod.save_weights(p, model)))
    path, ref = tmp_path / "net.npz", tmp_path / "ref.npz"
    save(str(path))
    flat = flax_conv_net_flat(model) if name == "raft" else flax_conv_net_flat(model, "params/")
    (np.savez_compressed if name == "raft" else np.savez)(str(ref), **flat)
    assert path.read_bytes() == ref.read_bytes()
    before = path.read_bytes()

    def dies(f, **arrays):
        f.write(b"PK\x03\x04 a partial archive")
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez_compressed" if name == "raft" else "savez", dies)
    with pytest.raises(KeyboardInterrupt):
        save(str(path))
    assert path.read_bytes() == before and sorted(os.listdir(tmp_path)) == ["net.npz",
                                                                             "ref.npz"]
