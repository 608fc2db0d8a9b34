"""The port's last small modules against the JAX package's: the
sampled-pixel read of data/vidloader.py and vidu4d_tpu_torch/utils/vis.py.
Every comparison is bitwise: both are the same numpy code on the same
inputs (the float16 -> float32 conversion is exact)."""

import os

import numpy as np
import pytest

from tests.helpers import make_fake_db
from vidu4d_tpu_torch.utils import vis as tvis


def test_read_raw_native_matches_numpy_and_jax(tmp_path):
    """read_raw of sampled pixels (the numpy gather from the memory maps)
    equals the JAX package's read_raw, every key, bitwise."""
    from vidu4d_tpu.data import data_utils as jdata
    from vidu4d_tpu_torch.data import data_utils as tdata

    db = make_fake_db(tmp_path, num_vids=1, T=8, H=16, W=16)
    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop", "train_res": 16,
            "pixels_per_image": 8}
    ds = tdata.build_datasets(opts)[0]
    jds = jdata.build_datasets(opts)[0]
    xy = np.random.default_rng(0).integers(0, 16, size=(8, 2)).astype(np.int64)
    for idx, delta in ((2, 1), (4, 2), (5, -1), (7, -2)):
        got, want = ds.read_raw(idx, delta, xy), jds.read_raw(idx, delta, xy)
        assert set(got) == set(want)
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
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
