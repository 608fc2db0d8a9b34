"""Stage 1's image ops, LK flow, depth prior, registration, canonical fit and
segmentation in the port against the JAX package, on the CPU.

Tolerances (float32 unless said):
* `resize` 1e-6 bilinear (JAX's antialiased triangle filter vs
  ``F.interpolate(antialias=True)``, measured <= 4.8e-7), nearest exact;
* the sampling / crop ops exactly, or 1e-5 where a division or a sum of
  four taps may round another way;
* `lk_flow` 1e-3 px: the box filter's cumulative sums run in another order
  (cancellation of sums over the whole image), then three Newton steps;
* `depth_from_flow_parallax` 1e-4 relative; the even-length median is the
  mean of the two middles in both;
* `two_frame_registration_np` 1e-5 (float64 Kabsch, float32 warps); the
  device `two_frame_registration` 2e-5 (float32 sums and SVD);
  `chain_poses` 1e-5 over 9 poses (JAX's associative scan groups the
  float32 products otherwise); the robust fit by a property (test
  docstring);
* the canonical fit: its objective's value (1e-5 relative) and gradients
  (1e-4 of each max |g|) at JAX's init carried across; the fit itself by
  its final loss (1e-3) and its constraints (test docstring);
* segmentation: masks differ at <= 0.5% of the pixels (a logit within
  rounding of 0 can fall either way; the 5 x 5 box sums and the histogram
  scatter-adds run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_segment import _make_pan_scene, _make_scene
from tests.torch_parity import assert_close, n, t
from vidu4d_tpu.ops import geometry as jgeom
from vidu4d_tpu.preprocess import depth as jdepth
from vidu4d_tpu.preprocess import flow as jflow
from vidu4d_tpu.preprocess import ops as jops
from vidu4d_tpu.preprocess import registration as jreg
from vidu4d_tpu.preprocess import segment as jseg
from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.ops import geometry as tgeom
from vidu4d_tpu_torch.preprocess import depth as tdepth
from vidu4d_tpu_torch.preprocess import flow as tflow
from vidu4d_tpu_torch.preprocess import ops as tops
from vidu4d_tpu_torch.preprocess import registration as treg
from vidu4d_tpu_torch.preprocess import segment as tseg

MASK_DIFF_SHARE = 5e-3


def _texture(rng, h, w):
    tex = rng.uniform(size=(h + 16, w + 16, 3)).astype(np.float32)
    return np.asarray(jax.vmap(jflow._blur, in_axes=-1, out_axes=-1)(jnp.asarray(tex)))


def _masks_close(ref, got, name=""):
    ref, got = np.asarray(ref) > 0.5, np.asarray(got) > 0.5
    share = float(np.mean(ref != got))
    assert share <= MASK_DIFF_SHARE, f"{name}: {share:.4%} of the mask pixels differ"


@pytest.mark.parametrize("case", ["up 16->112", "down 256->112", "nearest 37x53->112",
                                  "down 720x1280->128"])
def test_resize_matches_jax_image_resize(case):
    shapes = {"up 16->112": ((16, 16), (112, 112), "bilinear"),
              "down 256->112": ((256, 256), (112, 112), "bilinear"),
              "nearest 37x53->112": ((37, 53), (112, 112), "nearest"),
              "down 720x1280->128": ((720, 1280), (128, 128), "bilinear")}
    (h, w), (oh, ow), method = shapes[case]
    x = np.random.default_rng(0).uniform(size=(h, w, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (oh, ow, 3), method)
    got = tops.resize_hwc(t(x), (oh, ow), method)
    assert_close(ref, got, 0.0 if method == "nearest" else 1e-6)
    # the same over leading axes (N, C, H, W)
    got4 = tops.resize(t(x).permute(2, 0, 1)[None], (oh, ow), method)[0].permute(1, 2, 0)
    assert_close(ref, got4, 0.0 if method == "nearest" else 1e-6)


def test_nearest_sample_rounds_half_to_even():
    img = np.arange(6 * 7 * 2, dtype=np.float32).reshape(6, 7, 2)
    x = np.array([0.5, 1.5, 2.5, 2.49, 6.7, -3.0, 3.5], np.float32)
    y = np.array([0.5, 1.5, 4.5, 0.2, 5.9, 2.5, -1.0], np.float32)
    assert_close(jops.nearest_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)),
                 tops.nearest_sample(t(img), t(x), t(y)), 0.0)


@pytest.mark.parametrize("use_full", [False, True])
def test_crop_params_and_resample(use_full):
    rng = np.random.default_rng(1)
    h, w, cs = 40, 56, 24
    masks = np.zeros((3, h, w), np.float32)
    masks[0, 5:21, 9:40] = 1.0
    masks[1, 30:33, 50:55] = 1.0  # frame 2 stays empty: the full-image fallback
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    got = tops.compute_crop_params(t(masks), crop_size=cs, use_full=use_full)
    for i in range(3):
        ref = jops.compute_crop_params(jnp.asarray(masks[i]), crop_size=cs, use_full=use_full)
        assert_close(ref, got[i], 0.0, name=f"crop params {i}")
        for nearest in (False, True):
            assert_close(jops.crop_resample(jnp.asarray(img), ref, cs, nearest=nearest),
                         tops.crop_resample(t(img), got[i], cs, nearest=nearest), 1e-5,
                         name=f"resample {i} nearest={nearest}")


def test_flow_warp_crop_and_cycle_ops():
    rng = np.random.default_rng(2)
    h = w = 32
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    flow0 = rng.normal(0, 2.0, size=(h, w, 2)).astype(np.float32)
    flow1 = rng.normal(0, 2.0, size=(h, w, 2)).astype(np.float32)
    assert_close(jops.warp_by_flow(jnp.asarray(img), jnp.asarray(flow0)),
                 tops.warp_by_flow(t(img), t(flow0)), 1e-5)
    hp = rng.uniform(0, 60, size=(h, w, 3)).astype(np.float32)
    c2r = np.array([1.7, 1.6, 3.0, -2.0], np.float32)
    hxy = rng.uniform(0, 32, size=(h, w, 3)).astype(np.float32)
    assert_close(jops.flow_to_crop(jnp.asarray(flow0), jnp.asarray(hp), jnp.asarray(c2r),
                                   jnp.asarray(hxy)),
                 tops.flow_to_crop(t(flow0), t(hp), t(c2r), t(hxy)), 1e-5)
    occ = (rng.uniform(size=(h, w)) < 0.2).astype(np.float32)
    coords = (hxy[..., :2] + rng.normal(0, 0.3, size=(h, w, 2))).astype(np.float32)
    assert_close(jops.flow_cycle_uncertainty(jnp.asarray(occ), jnp.asarray(flow1),
                                             jnp.asarray(coords), jnp.asarray(hxy)),
                 tops.flow_cycle_uncertainty(t(occ), t(flow1), t(coords), t(hxy)), 1e-5)


def test_rot_angle_and_single_video():
    from vidu4d_tpu.data.frame_info import FrameInfo as JFrameInfo
    from scipy.spatial.transform import Rotation

    rots = Rotation.random(16, random_state=3).as_matrix().astype(np.float32)
    rots[0] = np.eye(3)
    assert_close(jgeom.rot_angle(jnp.asarray(rots)), tgeom.rot_angle(t(rots)), 1e-6)
    assert tuple(FrameInfo.single_video(7)) == tuple(JFrameInfo.single_video(7))


def test_lk_flow_and_occlusion_match_jax():
    rng = np.random.default_rng(5)
    tex = _texture(rng, 64, 64)
    img0, img1 = tex[8:72, 8:72], tex[8:72, 5:69]
    ref = jflow.lk_flow(jnp.asarray(img0), jnp.asarray(img1), levels=3)
    got = tflow.lk_flow(t(img0), t(img1), levels=3)
    assert_close(ref, got, 1e-3)
    back = jflow.lk_flow(jnp.asarray(img1), jnp.asarray(img0), levels=3)
    ref_occ = jflow.occlusion_from_cycle(ref, back)
    got_occ = tflow.occlusion_from_cycle(t(ref), t(back))
    assert_close(ref_occ, got_occ, 0.0)
    assert float(n(got_occ)[16:-16, 16:-16].mean()) < 0.1


@pytest.mark.parametrize("hw", [(32, 32), (16, 48)])
def test_depth_from_flow_parallax_matches_jax(hw):
    """Each frame's H*W is even, so the median is the mean of two middles."""
    rng = np.random.default_rng(6)
    h, w = hw
    tex = _texture(rng, h + 8, w + 8)
    frames = np.stack([tex[4:4 + h, 4 + i:4 + i + w] for i in range(4)])
    ref = jdepth.depth_from_flow_parallax(jnp.asarray(frames), levels=2)
    got = tdepth.depth_from_flow_parallax(t(frames), levels=2)
    assert_close(ref, got, 0.0, rtol=1e-4)
    x = np.array([[3.0, 0.0, 9.0, 4.0], [1.0, 2.0, 7.0, 5.0]], np.float32)
    assert_close(jnp.median(jnp.asarray(x), axis=-1), tdepth.median_last(t(x)), 0.0)


def _pair_scene(rng, h=32, w=32):
    depth0 = (2.0 + 0.3 * rng.uniform(size=(h, w))).astype(np.float32)
    depth1 = (depth0 + 0.01 * rng.normal(size=(h, w))).astype(np.float32)
    flow = rng.normal(0, 0.8, size=(h, w, 2)).astype(np.float32) + np.float32(1.5)
    kinv = np.linalg.inv(np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32))
    mask = (rng.uniform(size=(h, w)) > 0.3).astype(np.float32)
    return depth0, depth1, flow, kinv, mask


def test_two_frame_registration_np_matches_jax():
    rng = np.random.default_rng(7)
    depth0, depth1, flow, kinv, mask = _pair_scene(rng)
    for grad_weighting in (True, False):
        ref = jreg.two_frame_registration_np(depth0, depth1, flow, kinv, kinv, mask,
                                             grad_weighting=grad_weighting)
        got = treg.two_frame_registration_np(depth0, depth1, flow, kinv, kinv, mask,
                                             grad_weighting=grad_weighting)
        assert_close(ref, got, 1e-5)


def test_device_registration_and_chain_poses_match_jax():
    rng = np.random.default_rng(8)
    depth0, depth1, flow, kinv, mask = _pair_scene(rng)
    args = [depth0, depth1, flow, kinv, kinv, mask]
    ref = jreg.two_frame_registration(*[jnp.asarray(a) for a in args])
    assert_close(ref, treg.two_frame_registration(*[t(a) for a in args]), 2e-5)
    from scipy.spatial.transform import Rotation

    pair = np.tile(np.eye(4, dtype=np.float32), (9, 1, 1))
    pair[:, :3, :3] = Rotation.random(9, random_state=4).as_matrix()
    pair[:, :3, 3] = rng.normal(size=(9, 3))
    assert_close(jreg.chain_poses(jnp.asarray(pair)), treg.chain_poses(t(pair)), 1e-5)


def test_procrustes_recovers_rigid_motion():
    """The robust fit draws its hypotheses from a generator (JAX draws from
    a key): held by a property, an exact rigid motion recovered with 30%
    of the points replaced by outliers, and the weighted fit exact."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(9)
    r_gt = Rotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix().astype(np.float32)
    t_gt = np.array([0.3, -0.1, 0.2], np.float32)
    pts0 = rng.normal(size=(400, 3)).astype(np.float32)
    pts1 = pts0 @ r_gt.T + t_gt
    r, tt = treg.weighted_procrustes(t(pts0), t(pts1), torch.ones(400))
    assert_close(r_gt, r, 1e-5)
    assert_close(t_gt, tt, 1e-5)
    bad = rng.uniform(size=400) < 0.3
    pts1[bad] += rng.normal(0, 2.0, size=(int(bad.sum()), 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    r, tt = treg.robust_procrustes(t(pts0), t(pts1), torch.ones(400), gen)
    assert_close(r_gt, r, 1e-4)
    assert_close(t_gt, tt, 1e-4)


def _angles64(a, b):
    """Unclipped float64 angles of a b^T for (..., 3, 3) rotations."""
    m = np.asarray(a, np.float64) @ np.swapaxes(np.asarray(b, np.float64), -1, -2)
    return np.arccos(np.clip((np.trace(m, axis1=-2, axis2=-1) - 1) / 2, -1, 1))


def test_canonical_registration_matches_jax(monkeypatch):
    """The objective at JAX's PRNGKey(0) init (carried across by the
    converter): value to 1e-5 relative and every gradient to 1e-4 of its
    max |g|. Then the whole fit (200 + 200 Adam steps) from that init:
    Adam's first steps are lr * sign(g), which flips where g is near 0, and
    `rot_angle` is flat below its 0.0141 rad clip, so the two fits reach
    different rotations of equal loss: the final losses within 1e-3, and
    each result within 0.03 rad of every constraint (frame 0's annotation
    and each relative rotation), as JAX's is."""
    from scipy.spatial.transform import Rotation

    from tests.torch_parity import assert_close_to_max
    from vidu4d_tpu.data.frame_info import FrameInfo as JFrameInfo
    from vidu4d_tpu.models.fields.time_mlp import CameraMLP as JCameraMLP
    from vidu4d_tpu.models.fields.time_mlp import init_camera_base_params as jinit_base
    from vidu4d_tpu.ops.quaternion import quaternion_translation_to_se3 as jse3
    from vidu4d_tpu.preprocess import canonical as jcan
    from vidu4d_tpu_torch.convert import flax_to_state_dict, load_flax_params_
    from vidu4d_tpu_torch.models.fields.time_mlp import init_camera_base_params
    from vidu4d_tpu_torch.preprocess import canonical as tcan

    nt, iters = 8, 200
    view1 = np.tile(np.eye(4, dtype=np.float32), (nt, 1, 1))
    view1[:, :3, :3] = Rotation.from_rotvec(
        np.linspace(0, 0.6, nt)[:, None] * np.array([0.2, 1.0, 0.1])).as_matrix()
    view1[:, :3, 3] = np.linspace(0, 0.2, nt)[:, None]
    rel_gt = view1[1:, :3, :3] @ np.transpose(view1[:-1, :3, :3], (0, 2, 1))
    anno = {0: view1[0]}
    anno_all = np.tile(np.eye(4, dtype=np.float32), (nt, 1, 1))
    anno_all[0] = view1[0]

    fi = JFrameInfo.single_video(nt)
    jmodel = JCameraMLP(frame_info=fi, width=128, depth=3)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.arange(nt))
    model = tcan.camera_model(nt)
    load_flax_params_(model, jax.tree.map(np.array, jparams))

    def jloss(params):
        quat, trans = jmodel.apply(params, jnp.arange(nt))
        pred = jse3(quat, trans)
        unary = jgeom.rot_angle(pred[:1, :3, :3] @ jnp.swapaxes(anno_all[:1, :3, :3], -1, -2))
        rel = pred[1:, :3, :3] @ jnp.swapaxes(pred[:-1, :3, :3], -1, -2)
        return unary.mean() + jgeom.rot_angle(rel @ jnp.swapaxes(rel_gt, -1, -2)).mean()

    jp = jinit_base(jparams, anno_all, fi)
    jval, jgrad = jax.value_and_grad(jloss)(jp)
    init_camera_base_params(model, anno_all, FrameInfo.single_video(nt))
    val = tcan.canonical_loss(model, t(rel_gt), t(anno_all), torch.tensor([0]), 1.0)
    val.backward()
    assert_close(jval, val, 0.0, rtol=1e-5)
    ref_grads = flax_to_state_dict(jax.tree.map(np.array, jgrad))
    for name, p in model.named_parameters():
        assert_close_to_max(ref_grads[name], p.grad, 1e-4, name)

    ref, ref_loss = jcan.canonical_registration(anno, view1, num_iter=iters)
    seeded_model = tcan.camera_model

    def jax_init_model(num_frames):
        model = seeded_model(num_frames)
        load_flax_params_(model, jax.tree.map(np.array, jparams))
        return model

    monkeypatch.setattr(tcan, "camera_model", jax_init_model)
    got, loss = tcan.canonical_registration(anno, view1, num_iter=iters, device="cpu")
    assert abs(loss - ref_loss) < 1e-3, (loss, ref_loss)
    for cams in (ref, got):
        rel = cams[1:, :3, :3] @ np.transpose(cams[:-1, :3, :3], (0, 2, 1))
        assert _angles64(rel, rel_gt).max() < 0.03
        assert _angles64(cams[:1, :3, :3], view1[:1, :3, :3]).max() < 0.03


def test_propagate_masks_matches_jax():
    frames, gt = _make_scene(t=6)
    rng = np.random.default_rng(10)
    flows = rng.normal(0, 0.5, size=(5, 64, 64, 2)).astype(np.float32)
    flows[..., 0] -= 2.5
    ref = jseg.propagate_masks(jnp.asarray(frames), jnp.asarray(gt[0]), jnp.asarray(flows))
    got = tseg.propagate_masks(t(frames), t(gt[0]), t(flows))
    _masks_close(ref, got, "propagate_masks")
    bins = jseg._bin_ids(jnp.asarray(frames[0]))
    assert_close(bins, tseg._bin_ids(t(frames[0])), 0.0)
    assert_close(jseg._histogram(bins, jnp.asarray(gt[0])),
                 tseg._histogram(t(np.asarray(bins)).long(), t(gt[0])), 1e-4)


def test_motion_seed_mask_matches_jax():
    frames, gt = _make_pan_scene()
    ref = jseg.motion_seed_mask(frames)
    got = tseg.motion_seed_mask(frames, device="cpu")
    assert ref is not None and got is not None
    _masks_close(ref, got, "motion seed")
