"""The port's Stage 1 (`vidu4d_tpu_torch.preprocess.pipeline`) against the
JAX package's, file by file, on the CPU.

One clip serves the module: tests/test_preprocess.py's e2e video (10
frames of 48 x 64, a textured square moving over a textured background,
its masks given), through both packages' `preprocess_video` (crop 32,
deltas (1, 2), TSDF grid 32) and `write_config`. Bounds:
* crops within one float16 step (the bilinear taps round otherwise before
  the cast), annotations, crop2raw and is_detected equal, the same files;
* flow as tests/test_torch_preprocess_nets.py's RAFT bound plus the
  float16 step of the stored value (|v| <= 16 px: 2^-6); the occlusion
  channel at <= 0.5% of the pixels; depth within 4e-3 (float16 at 4);
* features: `pca_project` fed JAX's own backbone features (recomputed
  from the crops JAX's run fed them) gives JAX's file exactly; the port's
  file has the same masked-out pixels and unit vectors elsewhere;
* cameras: rotations within 2e-2 rad and translations within 2e-2 of
  JAX's (the pair fits see flow and depth read back from float16 files);
* the centred meshes: the same vertex bounds within 5% of the extent and
  a symmetric Chamfer distance within 2% of the extent (the TSDF of the
  fg cameras above; a voxel decision near the surface moves a vertex);
* canonical cameras: translations equal (both from the mask bbox), z in
  (0, 10]; rotations within 0.05 rad, the port's fit started from JAX's
  PRNGKey(0) init (measured 0.024: Adam's sign steps and the flat floor
  of the fit, see tests/test_torch_preprocess_ops.py);
* the config text equal but for the database root.
The segmentation backends, `filter_frames`, frames as PNG without imageio
and one Stage-2 training step on the port's database are tested too.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_preprocess import make_texture
from tests.test_segment import _make_scene
from tests.torch_parity import n, t
from vidu4d_tpu.preprocess import pipeline as jpipe
from vidu4d_tpu_torch.ops.geometry import rot_angle
from vidu4d_tpu_torch.ops.marching import load_obj
from vidu4d_tpu_torch.preprocess import features as tfeat
from vidu4d_tpu_torch.preprocess import pipeline as tpipe

SEQ, CROP, DELTAS = "synth-0000", 32, (1, 2)
MASK_DIFF_SHARE = 5e-3


def _clip():
    rng = np.random.default_rng(5)
    t_, h, w = 10, 48, 64
    bg = make_texture(rng, h, w)[:h, :w]
    frames = np.zeros((t_, h, w, 3), np.float32)
    masks = np.zeros((t_, h, w), np.float32)
    patch = rng.uniform(0.3, 1.0, size=(16, 16, 3)).astype(np.float32)
    for i in range(t_):
        frames[i] = bg
        x = 8 + 2 * i
        frames[i, 16:32, x:x + 16] = patch
        masks[i, 16:32, x:x + 16] = 1.0
    return frames, masks


@pytest.fixture(scope="module")
def jax_raft():
    """JAX's RAFT backend with its apply jitted (the JAX package applies it
    eagerly, op by op), for the module's JAX runs."""
    from vidu4d_tpu.preprocess import flow as jflow
    from vidu4d_tpu.preprocess import raft as jraft

    model = type("JittedRaft", (), {"apply": staticmethod(jax.jit(jraft.RaftSmall().apply))})
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jflow._RAFT_STATE, "tried", True)
        mp.setitem(jflow._RAFT_STATE, "model", model)
        mp.setitem(jflow._RAFT_STATE, "params", jraft.load_weights())
        yield


@pytest.fixture(scope="module")
def dbs(tmp_path_factory, jax_raft):
    """Both packages' databases of the clip, and the crops and masks JAX's
    run fed its feature extractor."""
    frames, masks = _clip()
    root = tmp_path_factory.mktemp("stage1")
    jroot, troot = str(root / "jax" / "database"), str(root / "port" / "database")
    fed = {}
    extract = jpipe.extract_video_features
    # the canonical fit starts from JAX's PRNGKey(0) init, carried across
    from vidu4d_tpu.data.frame_info import FrameInfo as JFrameInfo
    from vidu4d_tpu.models.fields.time_mlp import CameraMLP as JCameraMLP
    from vidu4d_tpu_torch.convert import load_flax_params_
    from vidu4d_tpu_torch.preprocess import canonical as tcan

    seeded_model = tcan.camera_model

    def jax_init_model(num_frames):
        model = seeded_model(num_frames)
        params = JCameraMLP(frame_info=JFrameInfo.single_video(num_frames), width=128,
                            depth=3).init(jax.random.PRNGKey(0), jnp.arange(num_frames))
        load_flax_params_(model, jax.tree.map(np.array, params))
        return model

    def spy(rgb_crop, masks=None, **kw):
        fed["rgb_crop"], fed["mask_crop"] = np.array(rgb_crop), np.array(masks)
        return extract(rgb_crop, masks=masks, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "extract_video_features", spy)
        jpipe.preprocess_video(frames, jroot, SEQ, masks=masks, crop_size=CROP,
                               delta_list=DELTAS, tsdf_grid=32)
    jpipe.write_config(jroot, "synth", crop_size=CROP)
    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcan, "camera_model", jax_init_model)
        tpipe.preprocess_video(frames, troot, SEQ, masks=masks, crop_size=CROP,
                               delta_list=DELTAS, tsdf_grid=32, device="cpu", stats=stats)
    tpipe.write_config(troot, "synth", crop_size=CROP)
    return {"jax": jroot, "port": troot, "fed": fed, "stats": stats, "frames": frames,
            "masks": masks}


def _load(root, kind, name):
    return np.load(os.path.join(root, "processed", kind, "Full-Resolution", SEQ, name))


def _files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def test_same_files_and_backends(dbs):
    assert _files(dbs["jax"]) == _files(dbs["port"])
    s = dbs["stats"]
    assert (s["flow"], s["depth"], s["features"]) == ("raft", "depthnet", "featnet")
    assert set(s["seconds"]) >= {"segment", "crop", "flow_1", "flow_2", "depth", "features",
                                 "registration", "tsdf", "marching_weld", "canonical",
                                 "total"}


def test_crops_and_annotations_match_jax(dbs):
    pre = f"crop-{CROP}"
    ref, got = (_load(dbs[k], "JPEGImages", f"{pre}.npy") for k in ("jax", "port"))
    assert ref.dtype == got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32), atol=2 ** -10)
    for name in (f"{pre}.npy", f"{pre}-crop2raw.npy", f"{pre}-is_detected.npy"):
        ref, got = (_load(dbs[k], "Annotations", name) for k in ("jax", "port"))
        assert ref.dtype == got.dtype and ref.shape == got.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("kind", ["FlowFW_1", "FlowBW_1", "FlowFW_2", "FlowBW_2"])
def test_flow_files_match_jax(dbs, kind):
    ref, got = (_load(dbs[k], kind, f"crop-{CROP}.npy").astype(np.float32)
                for k in ("jax", "port"))
    assert ref.shape == got.shape
    np.testing.assert_allclose(got[..., :2], ref[..., :2], atol=2e-4 + 2 ** -6)
    assert float(np.mean(got[..., 2] != ref[..., 2])) <= MASK_DIFF_SHARE


def test_depth_matches_jax(dbs):
    ref, got = (_load(dbs[k], "Depth", f"crop-{CROP}.npy") for k in ("jax", "port"))
    assert ref.dtype == got.dtype == np.float16 and ref.shape == got.shape
    np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32), atol=4e-3)


def test_features_match_jax_through_pca_project(dbs):
    from tests.test_torch_preprocess_nets import _jax_backbone

    name = f"crop-{CROP}-dinov2-01.npy"
    ref, got = (_load(dbs[k], "Features", name) for k in ("jax", "port"))
    fed = dbs["fed"]
    jb = _jax_backbone(fed["rgb_crop"], "featnet", 112)
    np.testing.assert_array_equal(tfeat.pca_project(jb, fed["mask_crop"]), ref)
    off = np.all(got == 0, axis=-1)
    np.testing.assert_array_equal(off, np.all(ref == 0, axis=-1))
    assert np.abs(np.linalg.norm(got.astype(np.float32), axis=-1)[~off] - 1).max() < 2e-3


@pytest.mark.parametrize("name", ["00.npy", "01.npy"])
def test_cameras_match_jax_by_rotation_angle(dbs, name):
    ref, got = (_load(dbs[k], "Cameras", name) for k in ("jax", "port"))
    assert ref.shape == got.shape == (10, 4, 4) and got.dtype == np.float32
    ang = n(rot_angle(t(got[:, :3, :3]) @ t(ref[:, :3, :3]).transpose(-1, -2)))
    assert ang.max() < 2e-2, ang  # rot_angle's clip floor is 0.0141
    np.testing.assert_allclose(got[:, :3, 3], ref[:, :3, 3], atol=2e-2)


def test_centered_mesh_matches_jax(dbs):
    path = lambda k: os.path.join(dbs[k], "processed", "Cameras", "Full-Resolution", SEQ,
                                  "mesh-01-centered.obj")
    (vj, fj), (vt, ft) = load_obj(path("jax")), load_obj(path("port"))
    assert len(vj) and len(vt) and len(fj) and len(ft)
    extent = float((vj.max(0) - vj.min(0)).max())
    np.testing.assert_allclose(vt.min(0), vj.min(0), atol=0.05 * extent)
    np.testing.assert_allclose(vt.max(0), vj.max(0), atol=0.05 * extent)
    d = torch.cdist(t(vt), t(vj))
    chamfer = 0.5 * float(d.min(1).values.mean() + d.min(0).values.mean())
    assert chamfer < 0.02 * extent, (chamfer, extent)
    with open(path("port")) as a, open(path("port").replace("01", "00")) as b:
        assert a.read() == b.read()  # mesh-00 is a copy of the fg mesh, as in JAX


def test_canonical_cameras_match_jax(dbs):
    ref, got = (_load(dbs[k], "Cameras", "01-canonical.npy") for k in ("jax", "port"))
    assert got.shape == (10, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :3, 3], ref[:, :3, 3], rtol=1e-6, atol=1e-6)
    assert (got[:, 2, 3] > 0).all() and (got[:, 2, 3] <= 10.0 + 1e-5).all()
    ang = n(rot_angle(t(got[:, :3, :3]) @ t(ref[:, :3, :3]).transpose(-1, -2)))
    assert ang.max() < 0.05, ang


def test_config_text_matches_jax(dbs):
    texts = {}
    for k in ("jax", "port"):
        with open(os.path.join(dbs[k], "configs", "synth.config")) as f:
            texts[k] = f.read().replace(dbs[k], "<root>")
    assert texts["port"] == texts["jax"]


def test_frames_as_png_without_imageio(dbs, tmp_path, monkeypatch):
    """Without imageio the frames are PNGs and the config is the same
    text; video decoding says it needs imageio."""
    monkeypatch.setattr(tpipe, "_imageio", lambda: None)
    root = str(tmp_path / "database")
    seq = os.path.join(root, "processed", "JPEGImages", "Full-Resolution", SEQ)
    os.makedirs(seq)
    assert tpipe.write_frames(dbs["frames"], seq) == "png"
    assert len(glob.glob(os.path.join(seq, "*.png"))) == 10
    tpipe.write_config(root, "synth", crop_size=CROP)
    with open(os.path.join(root, "configs", "synth.config")) as f:
        png_text = f.read().replace(root, "<root>")
    with open(os.path.join(dbs["jax"], "configs", "synth.config")) as f:
        assert png_text == f.read().replace(dbs["jax"], "<root>")
    np.testing.assert_allclose(tpipe.load_frames_dir(seq), dbs["frames"], atol=1 / 255)
    with pytest.raises(ImportError, match="imageio"):
        tpipe.extract_frames(str(tmp_path / "clip.mp4"), str(tmp_path / "raw"))


@pytest.mark.parametrize("backend", ["flow", "auto"])
def test_segment_backends_match_jax(jax_raft, backend):
    """segment_video on _make_scene's drifting disc: "flow" from the given
    seed, "auto" from the motion seed (the clip's static camera)."""
    from vidu4d_tpu.preprocess import segment as jseg
    from vidu4d_tpu_torch.preprocess import segment as tseg

    frames, gt = _make_scene(t=6)
    seed = gt[0] if backend == "flow" else None
    ref = jseg.segment_video(frames, seed_mask=seed, auto_seed=backend == "auto")
    stats = {}
    got = tseg.segment_video(frames, seed_mask=seed, auto_seed=backend == "auto",
                             device="cpu", stats=stats)
    assert stats["seed"] == ("given" if backend == "flow" else "motion")
    assert stats["flow"] == "raft" and got.shape == gt.shape and got.dtype == np.float32
    share = float(np.mean((got > 0.5) != (ref > 0.5)))
    assert share <= MASK_DIFF_SHARE, share


def test_filter_frames_matches_jax():
    rng = np.random.default_rng(5)
    tex = rng.uniform(0, 1, size=(64, 64, 3)).astype(np.float32)
    moving = np.stack([np.roll(tex, 4 * i, axis=1) for i in range(14)])
    moving[5] = moving[4]  # a repeated frame is dropped
    for video in (moving, np.stack([tex] * 14)):
        ref = jpipe.filter_frames(video, flow_threshold=0.01, min_frames=4, work_res=64)
        got = tpipe.filter_frames(video, flow_threshold=0.01, min_frames=4, work_res=64,
                                  device="cpu")
        assert (ref is None) == (got is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)


def test_port_database_trains_stage2(dbs, tmp_path):
    """The port's database read back by the port's loaders and one Stage-2
    step on it."""
    from vidu4d_tpu_torch.data import data_utils
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer

    opts = {"dataroot": dbs["port"], "seqname": "synth", "logname": "s1", "logroot":
            str(tmp_path), "data_prefix": "crop", "train_res": CROP, "pixels_per_image": 4,
            "imgs_per_gpu": 2, "num_rounds": 1, "iters_per_round": 1, "fg_motion": "bob",
            "field_depth": 2, "field_width": 32, "train_depth_samples": 8, "seed": 0,
            "delta_list": [2]}
    datasets = data_utils.build_datasets(opts)
    info = data_utils.get_data_info(datasets)
    assert info["rtmat"].shape[1] == 10 and np.isfinite(info["rtmat"]).all()
    m = Stage2Trainer(opts, "cpu").train_step()
    assert all(np.isfinite(float(v)) for v in m.values()), m


def test_stage1_entry_points_take_the_card_by_default(tmp_path):
    """Stage 1's entry points run on the card unless asked for the CPU;
    without one they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from vidu4d_tpu_torch.preprocess import canonical, depth, segment

    frames = np.random.default_rng(0).uniform(size=(3, 16, 16, 3)).astype(np.float32)
    calls = [
        lambda: tpipe.preprocess_video(frames, str(tmp_path / "db"), SEQ, crop_size=16),
        lambda: segment.segment_video(frames, auto_seed=True),
        lambda: depth.estimate_depth(frames),
        lambda: tfeat.extract_video_features(frames),
        lambda: canonical.canonical_registration({0: np.eye(4)}, np.stack([np.eye(4)] * 3),
                                                 num_iter=1),
    ]
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            call()
