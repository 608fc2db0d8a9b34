"""The port's end-to-end quality run and depth scorers
(`vidu4d_tpu_torch.examples.synthetic_e2e`,
`vidu4d_tpu_torch.preprocess.eval_depthnet`,
`vidu4d_tpu_torch.preprocess.eval_depth_registration`) against the JAX
package's scripts (`examples/synthetic_e2e.py`, `scripts/eval_depthnet.py`,
`scripts/eval_depth_registration.py`, loaded by path), on the CPU.

Tolerances:
* `make_gt_video` at 32 x 32, 4 frames, with JAX's surfel rotations
  (`init_from_points`' PRNGKey(0)): masks and depth within 1e-5, frames
  within 1e-4 (the tiles path's cross product and the slab's affine form
  round the splat response differently: 5.0e-5 measured), except at pixels where a splat sits at the 1/255 alpha cut of one
  rasterizer and not the other (at most 0.5% of the pixels); no tile holds
  more than the JAX tiles path's budget of 512 entries (which would drop
  the rest);
* `make_gt_video_raymarch` at 32 x 32, 4 frames (white; textured with a
  0.02 camera shake): frames, masks and depth within 1e-4, except where
  the hit test |sdf| < 2e-3 flips (at most 0.5% of the pixels);
* `score_renders` against the JAX script's scoring block on seeded arrays:
  PSNR within 1e-4 dB, the rest within 1e-5;
* the depth scorers' mains against the JAX scripts' on the shipped weights
  with JAX's surfel rotations: SSI-MAE and DepthNet's order accuracy
  within 1e-4 (the flow parallax's, of a static pair, is rounding noise:
  0.05), rotation errors within 1e-2 degrees;
* the port's e2e at 32 x 32 with a tiny schedule writes a metrics.json with
  every key of the JAX main run's, all finite; with ``--resume`` it skips
  Stages 1 and 2, reloads Stage 3, and without imageio writes the
  side-by-side frames as .npy.
"""

import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from vidu4d_tpu_torch.examples import synthetic_e2e as te2e
from vidu4d_tpu_torch.models.gaussian import surfels as tsf
from vidu4d_tpu_torch.ops.rasterize import common
from vidu4d_tpu_torch.preprocess import eval_depth_registration as treg
from vidu4d_tpu_torch.preprocess import eval_depthnet as tevd
from vidu4d_tpu_torch.preprocess import train_depthnet as tdepth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHNET_NPZ = os.path.join(REPO, "vidu4d_tpu", "weights", "depthnet_synthetic.npz")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    """The JAX scripts as modules (they import `scripts.*` and
    `vidu4d_tpu.*` from the repo root)."""
    return {"e2e": _load("examples/synthetic_e2e.py", "jax_synthetic_e2e"),
            "eval_depthnet": _load("scripts/eval_depthnet.py", "jax_eval_depthnet"),
            "eval_registration": _load("scripts/eval_depth_registration.py",
                                       "jax_eval_depth_registration")}


def _jax_rotations(count):
    """The rotations JAX's `init_from_points` draws (its default key)."""
    return torch.as_tensor(np.array(jax.random.uniform(jax.random.PRNGKey(0), (count, 4))))


def test_make_gt_video_matches_jax(jax_scripts):
    res, frames, n_splats = 32, 4, 400
    rot = _jax_rotations(n_splats)
    ref = jax_scripts["e2e"].make_gt_video(res, frames)
    got = te2e.make_gt_video(res, frames, rotations=rot, device="cpu")
    # the tile budget of the JAX tiles path: no frame may drop an entry
    state = te2e.blob_splats(n_splats, 0, rot)
    p = state.params
    intrins = t([1.2 * res, 1.2 * res, res / 2, res / 2])
    for f in range(frames):
        breathe = 1.0 + 0.1 * np.sin(0.5 * f)
        xyz = (n(p.xyz) * breathe) @ te2e.y_rotation(0.08 * f).T + np.array([0, 0, 0.5])
        proj = common.project_splats(t(xyz), tsf.get_rotation(p), tsf.get_scaling(p),
                                     torch.eye(4), intrins, mask=state.alive)
        binning = common.bin_splats_aligned(proj, res, res)
        assert 0 < int(binning.tile_count.max()) <= 512
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(ref, got))
    # the colour within 1e-4: the tiles path's cross product and the slab's
    # affine form round the splat response differently (5.0e-5 measured on
    # 1.6% of the pixels here); masks and depth within 1e-5
    diff = np.maximum.reduce([np.abs(np.asarray(ref[0]) - got[0]).max(-1) / 10,
                              np.abs(np.asarray(ref[1]) - got[1]),
                              np.abs(np.asarray(ref[2]) - got[2])])
    assert (diff > 1e-5).mean() <= 5e-3, (diff > 1e-5).mean()
    assert got[1].mean() > 0.2  # the blob is in view


@pytest.mark.parametrize("background,cam_jitter", [("white", 0.0), ("textured", 0.02)])
def test_make_gt_video_raymarch_matches_jax(jax_scripts, background, cam_jitter):
    res, frames = 32, 4
    ref = jax_scripts["e2e"].make_gt_video_raymarch(res, frames, background=background,
                                                    cam_jitter=cam_jitter)
    got = te2e.make_gt_video_raymarch(res, frames, background=background,
                                      cam_jitter=cam_jitter, device="cpu")
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(ref, got))
    flip = ref[1] != got[1]
    assert flip.mean() <= 5e-3, flip.mean()
    for a, b in zip(ref, got):
        diff = np.abs(a - b)
        if diff.ndim == 4:
            diff = diff.max(-1)
        assert diff[~flip].max() <= 1e-4
    assert 0.1 < got[1].mean() < 0.9
    if background == "textured":  # the background is not the white one
        assert np.abs(got[0][got[1] == 0] - 1.0).max() > 0.1


def _jax_scores(rendered, gt, gt_masks, gt_depth):
    """The JAX script's scoring block (`synthetic_e2e.py:396-446`), with
    its own psnr / ssim, before the rounding."""
    from vidu4d_tpu.ops.image_losses import psnr, ssim

    n_eval = rendered["rendered"].shape[0]
    psnrs = [float(psnr(jnp.asarray(rendered["rendered"][i]), jnp.asarray(gt[i])))
             for i in range(n_eval)]
    ssims = [float(ssim(jnp.asarray(rendered["rendered"][i]).transpose(2, 0, 1),
                        jnp.asarray(gt[i]).transpose(2, 0, 1))) for i in range(n_eval)]
    out = {"render_psnr_mean": float(np.mean(psnrs)), "render_psnr_per_frame": psnrs,
           "render_ssim_mean": float(np.mean(ssims))}
    fg = []
    for i in range(n_eval):
        m = np.asarray(gt_masks[i]) > 0.5
        if m.sum() > 16:
            mse = float(np.mean((np.asarray(rendered["rendered"][i])[m] - gt[i][m]) ** 2))
            fg.append(-10.0 * np.log10(max(mse, 1e-10)))
    out["render_psnr_fg_mean"] = float(np.mean(fg))
    alpha_r = np.asarray(rendered["mask"])[..., 0]
    depth_r = np.asarray(rendered["depth"])[..., 0] / np.maximum(alpha_r, 1e-6)
    d_errs, ious = [], []
    for i in range(n_eval):
        gt_m, r_m = gt_depth[i] > 0, alpha_r[i] > 0.5
        both = gt_m & r_m
        if both.sum() > 16:
            d_errs.append(float(np.sqrt(np.mean((depth_r[i][both] - gt_depth[i][both]) ** 2))))
        ious.append(float((gt_m & r_m).sum() / max((gt_m | r_m).sum(), 1)))
    out["render_depth_rmse"] = float(np.mean(d_errs))
    out["render_mask_iou"] = float(np.mean(ious))
    return out


def test_score_renders_matches_the_jax_block():
    rng = np.random.default_rng(5)
    m, res = 3, 32
    gt = rng.uniform(size=(m, res, res, 3)).astype(np.float32)
    yy, xx = np.mgrid[:res, :res]
    gt_masks = np.stack([((yy - 16) ** 2 + (xx - 14 - k) ** 2 < 90).astype(np.float32)
                         for k in range(m)])
    gt_depth = gt_masks * rng.uniform(0.4, 0.6, size=(m, res, res)).astype(np.float32)
    alpha = np.clip(gt_masks + rng.normal(0, 0.3, size=gt_masks.shape), 0, 1)
    rendered = {
        "rendered": np.clip(gt + rng.normal(0, 0.05, size=gt.shape), 0, 1).astype(np.float32),
        "mask": alpha[..., None].astype(np.float32),
        "depth": (alpha * (gt_depth + rng.normal(0, 0.02, size=gt_depth.shape)))[
            ..., None].astype(np.float32),
    }
    ref = _jax_scores(rendered, gt, gt_masks, gt_depth)
    got = te2e.score_renders(rendered, gt, gt_masks, gt_depth)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["render_psnr_per_frame"], ref["render_psnr_per_frame"],
                               atol=1e-4)
    for k in ("render_psnr_mean", "render_psnr_fg_mean"):
        assert abs(got[k] - ref[k]) <= 1e-4, k
    for k in ("render_ssim_mean", "render_depth_rmse", "render_mask_iou"):
        assert abs(got[k] - ref[k]) <= 1e-5, k
    assert 0.0 < got["render_mask_iou"] < 1.0


def test_eval_depthnet_main_matches_jax(jax_scripts, monkeypatch):
    """Both scripts at 32 x 32, one batch of one scene, on the shipped
    weights: the JAX script's numbers (recorded from its ssi_mae and
    order_accuracy calls: it only prints them) against the port's main."""
    jmod = jax_scripts["eval_depthnet"]
    rec = {"mae": [], "acc": []}
    ssi, acc = jmod.ssi_mae, jmod.order_accuracy

    def ssi_rec(*a):
        rec["mae"].append(float(ssi(*a)))
        return rec["mae"][-1]

    def acc_rec(*a):
        rec["acc"].append(acc(*a))
        return rec["acc"][-1]

    monkeypatch.setattr(jmod, "ssi_mae", ssi_rec)
    monkeypatch.setattr(jmod, "order_accuracy", acc_rec)
    argv = ["--weights", DEPTHNET_NPZ, "--res", "32", "--batch", "1", "--rounds", "1"]
    monkeypatch.setattr(sys, "argv", ["eval_depthnet.py"] + argv)
    jmod.main()
    got = tevd.main(argv + ["--device", "cpu"], rotations=_jax_rotations(tdepth.SCENE_CAP))
    assert len(rec["mae"]) == 1 and len(rec["acc"]) == 2
    assert abs(got["ssi_mae"] - rec["mae"][0]) <= 1e-4
    assert abs(got["order_acc"] - rec["acc"][0]) <= 1e-4
    # the flow parallax of a static pair (the script feeds one frame twice)
    # is the LK solver's rounding noise, median-normalised: its depth maps
    # differ by up to ~1 between the packages and order pixel pairs at
    # chance, so its accuracy is held to the binomial spread of two chance
    # draws over the ~1000 kept pairs (3 sigma ~ 0.05), not to 1e-4
    assert abs(got["flow_parallax_order_acc"] - rec["acc"][1]) <= 0.05
    assert got["order_acc"] > 0.6


def test_eval_depth_registration_main_matches_jax(jax_scripts, monkeypatch, tmp_path):
    """Both scripts at 64 x 64 on 4 frames (at 32 x 32 RAFT's flow marks
    every pixel occluded, and every registration is the identity in both
    packages): each depth source's pair and chained rotation errors."""
    jmod = jax_scripts["eval_registration"]
    argv = ["--res", "64", "--frames", "4"]
    monkeypatch.setattr(sys, "argv", ["eval_depth_registration.py", *argv, "--out",
                                      str(tmp_path / "jax.json")])
    jmod.main()
    ref = json.loads((tmp_path / "jax.json").read_text())
    out = tmp_path / "port.json"
    got = treg.main(argv + ["--device", "cpu", "--out", str(out)], rotations=_jax_rotations(500))
    assert json.loads(out.read_text()) == got
    assert set(got) == set(ref) == {"gt_depth", "depthnet", "flow_parallax"}
    for source, errs in ref.items():
        assert set(got[source]) == set(errs)
        for k, v in errs.items():
            assert abs(got[source][k] - v) <= 1e-2, (source, k, got[source][k], v)
    # the GT depth registers better than the whole turn of a pair
    assert got["gt_depth"]["pair_rot_err_deg_mean"] < math.degrees(0.08)


def test_e2e_main_writes_the_jax_metrics_and_resumes(tmp_path, monkeypatch, capsys):
    """The port's run at 32 x 32 on 8 frames with a tiny schedule (Stage
    1's canonical fit cut to 2 x 50 steps, the SDF pretrain to 30: their
    parity is tests/test_torch_preprocess_pipeline.py's and
    tests/test_torch_stage2.py's), then again with --resume and imageio
    hidden. At this schedule the squeezed OneCycle warm-up of the warp
    AdamW walks the camera off the object (in the JAX package too), so
    the render and the GT share no surface and the depth RMSE, which the
    JAX script writes only where they do, is left out."""
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
    from vidu4d_tpu_torch.preprocess import pipeline

    canonical, mlp_init = pipeline.canonical_registration, Stage2Trainer.mlp_init
    monkeypatch.setattr(pipeline, "canonical_registration",
                        lambda *a, **kw: canonical(*a, **{**kw, "num_iter": 50}))
    monkeypatch.setattr(Stage2Trainer, "mlp_init",
                        lambda self, **kw: mlp_init(self, **{**kw, "sdf_iters": 30}))
    jax_keys = set(json.load(open(os.path.join(REPO, "examples", "results", "metrics.json"))))
    jax_keys.discard("render_depth_rmse")
    argv = ["--device", "cpu", "--out", str(tmp_path), "--res", "32", "--frames", "8",
            "--s2_rounds", "1", "--s2_iters", "2", "--s3_rounds", "1", "--s3_iters", "2"]
    out = te2e.main(argv)
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert jax_keys <= set(metrics), sorted(jax_keys - set(metrics))
    assert metrics["config"]["device"] == "cpu"
    nums = [v for k, v in metrics.items() if k != "config"]
    flat = [x for v in nums for x in (v if isinstance(v, list) else [v])]
    assert all(math.isfinite(x) for x in flat)
    assert len(metrics["render_psnr_per_frame"]) == 7
    assert out["launches"]["tile_forward"] == 0  # CPU tensors: the plain versions
    assert out["launches"]["tile_forward_plain"] == 8 + 2 + 1 + 1  # GT, steps, eval, reference
    assert out["launches"]["tile_backward_plain"] == 2
    videos = [f for f in os.listdir(tmp_path) if f.startswith("render_vs_gt")]
    assert videos and not videos[0].endswith(".npy")
    capsys.readouterr()

    monkeypatch.setitem(sys.modules, "imageio", None)
    again = te2e.main(argv + ["--resume"])
    log = capsys.readouterr().out
    assert "[stage1] resume" in log and "[stage2] resume" in log
    assert "[stage3] resume from round 1" in log
    assert "imageio is not installed" in log
    side = np.load(tmp_path / "render_vs_gt.npy")
    assert side.shape == (7, 32, 64, 3)
    # nothing trained again: the reloaded Stage 3 renders what it rendered
    assert again["render_psnr_per_frame"] == metrics["render_psnr_per_frame"]
    assert again["launches"]["tile_backward_plain"] == 0
