"""End-to-end quality run of the port (`examples/synthetic_e2e.py`):
synthetic video -> Stage 1 -> Stage 2 -> Stage 3 -> render.

A ground-truth video (a rotating, breathing surfel blob rendered by the
port's rasterizer, or a sphere-traced SDF blob that no rasterizer touches)
goes through the whole pipeline from raw frames: preprocessing (masks
given, or tracked), the neural-SDF stage, the dynamic-surfel stage, and a
reference-view render, scored against the input frames (PSNR, SSIM,
foreground PSNR, depth RMSE, mask IoU). Writes the artifacts and
``metrics.json`` (the JAX script's keys) under ``--out``.

    python -m vidu4d_tpu_torch.examples.synthetic_e2e --out e2e --res 64 \\
        --frames 16 [--device cpu]

The flags and defaults are the JAX script's, plus ``--device`` (the card
unless "cpu"; a card that is not there raises) and ``--out``'s default,
under the temporary directory. ``make_gt_video`` takes the surfels'
``rotations``; without them they are drawn from a ``torch.Generator``
seeded with ``seed`` (the JAX script's come from ``PRNGKey(0)`` inside
``init_from_points``). The JAX script renders the ground truth with
``RasterizeConfig(budget=512, tile_chunk=4)`` on the tiles path; the port
has the kernels' exact path, equal while no tile holds more than 512
entries (400 splats: at most one entry each per tile). The Stage-3 options
``raster_budget`` / ``raster_tile_chunk`` are taken and ignored, as the
JAX kernel path ignores them. Without imageio the side-by-side frames are
written as ``render_vs_gt.npy`` instead of a video.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.ops.image_losses import psnr, ssim
from vidu4d_tpu_torch.ops.rasterize.api import rasterize
from vidu4d_tpu_torch.preprocess.train_common import train_device

# the raymarched blob: base radius, depth of its centre; 48 sphere-tracing
# steps of at most 0.05; a surface hit within 2e-3
R0, CENTER_Z, TRACE_STEPS, HIT_EPS = 0.12, 0.5, 48, 2e-3
LIGHT = (0.4, -0.5, -0.76)


def y_rotation(ang: float, dtype=np.float32) -> np.ndarray:
    """The (3, 3) rotation by ``ang`` radians about y."""
    return np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]], dtype)


def blob_splats(n_splats: int, seed: int, rotations: Optional[torch.Tensor]) -> sf.SurfelState:
    """The textured surfel blob on the CPU (`synthetic_e2e.py:41-56`):
    points on a 0.12 shell (radial jitter 0.7-1.0), random colours,
    opacity logit 4.0, scale 0.02."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_splats, 3)).astype(np.float32)
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-6)
    pts *= rng.uniform(0.7, 1.0, size=(n_splats, 1)).astype(np.float32) * 0.12
    cols = rng.uniform(0.1, 1.0, size=(n_splats, 3)).astype(np.float32)
    with torch.no_grad():
        state = sf.init_from_points(torch.as_tensor(pts), torch.as_tensor(cols),
                                    capacity=n_splats, sh_degree=0,
                                    generator=torch.Generator().manual_seed(seed))
        p = state.params
        params = p._replace(
            rotation=p.rotation if rotations is None else torch.as_tensor(
                rotations, dtype=torch.float32).reshape(p.rotation.shape),
            opacity=torch.full_like(p.opacity, 4.0),  # sigmoid ~0.98: near-opaque
            scaling=torch.full_like(p.scaling, float(np.log(0.02))),
        )
    return state._replace(params=sf.SurfelParams(*(x.detach() for x in params)))


@torch.no_grad()
def render_blob(state: sf.SurfelState, xyz_frames, res: int, device):
    """Each (P, 3) numpy position set of ``state``'s splats through
    `rasterize` (the forward tile kernel on the card; one call per frame)
    from the identity camera: SH degree 0, white background, intrinsics
    [1.2 res, 1.2 res, res / 2, res / 2]. Returns (colour (T, res, res,
    3), alpha (T, res, res), alpha-normalised depth where alpha > 0.3, 0
    elsewhere) numpy."""
    p = sf.SurfelParams(*(x.to(device) for x in state.params))
    quats, scales = sf.get_rotation(p), sf.get_scaling(p)
    opac, shs = sf.get_opacity(p)[:, 0], sf.get_features(p)
    alive = state.alive.to(device)
    intrins = torch.tensor([1.2 * res, 1.2 * res, res / 2, res / 2], device=device)
    eye, white = torch.eye(4, device=device), torch.ones(3, device=device)
    colors, alphas, depths = [], [], []
    for xyz in xyz_frames:
        out = rasterize(torch.as_tensor(xyz, dtype=torch.float32, device=device), quats,
                        scales, opac, eye, intrins, res, res, shs=shs, sh_degree=0,
                        bg_color=white, mask=alive)
        a = out.alpha.cpu().numpy()
        colors.append(out.color.cpu().numpy())
        alphas.append(a)
        depths.append(out.depth.cpu().numpy() / np.maximum(a, 1e-6) * (a > 0.3))
    return np.stack(colors), np.stack(alphas), np.stack(depths)


def make_gt_video(res: int, n_frames: int, n_splats: int = 400, seed: int = 0,
                  motion_scale: float = 1.0, rotations: Optional[torch.Tensor] = None,
                  device="cuda"):
    """Render a rotating, breathing surfel blob (`synthetic_e2e.py:28`):
    (frames (T, res, res, 3), masks alpha > 0.3 (T, res, res) float32, GT
    depth (T, res, res)) numpy, by `render_blob`. motion_scale multiplies
    the rotation / breathing rates (at 1.0 the largest delta-1 flow is
    ~1.5 px)."""
    state = blob_splats(n_splats, seed, rotations)
    xyz0 = state.params.xyz.numpy()
    xyz_frames = []
    for t in range(n_frames):
        breathe = 1.0 + 0.1 * np.sin(0.5 * motion_scale * t)
        xyz_t = (xyz0 * breathe) @ y_rotation(0.08 * motion_scale * t).T
        xyz_frames.append(xyz_t + np.array([0, 0, 0.5], np.float32))
    frames, alpha, depth = render_blob(state, xyz_frames, res, device)
    return frames, (alpha > 0.3).astype(np.float32), depth


def _trilinear(lattice: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a (n, n, n, 3) lattice at u (..., 3) >= 0 (the
    lattice index of the lower corner is floor(u))."""
    i = torch.floor(u).long()
    f = u - i
    fx, fy, fz = f[..., :1], f[..., 1:2], f[..., 2:3]

    def tap(dx, dy, dz):
        return lattice[i[..., 0] + dx, i[..., 1] + dy, i[..., 2] + dz]

    return (tap(0, 0, 0) * (1 - fx) * (1 - fy) * (1 - fz)
            + tap(1, 0, 0) * fx * (1 - fy) * (1 - fz)
            + tap(0, 1, 0) * (1 - fx) * fy * (1 - fz)
            + tap(0, 0, 1) * (1 - fx) * (1 - fy) * fz
            + tap(1, 1, 0) * fx * fy * (1 - fz)
            + tap(1, 0, 1) * fx * (1 - fy) * fz
            + tap(0, 1, 1) * (1 - fx) * fy * fz
            + tap(1, 1, 1) * fx * fy * fz)


@torch.no_grad()
def make_gt_video_raymarch(res: int, n_frames: int, seed: int = 0,
                           motion_scale: float = 1.0, background: str = "white",
                           cam_jitter: float = 0.0, device="cuda"):
    """GT video from no rasterizer (`synthetic_e2e.py:89`): a sphere-traced
    SDF blob (a 0.12 sphere with 6 gaussian bumps) rotating and breathing,
    textured by trilinear 3D value noise at canonical coordinates,
    Lambertian shaded; plain torch math on ``device``. ``background``
    "textured" composites over a bilinear 9 x 9 colour lattice panning
    slowly; ``cam_jitter`` adds a per-frame Rodrigues rotation (radians)
    and translation (0.1 x) shake from ``default_rng(seed + 101)``.
    Returns (frames, masks, depth) numpy as `make_gt_video` does; the
    depth is the ray distance at a hit, 0 elsewhere."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    bump_c = f32(rng.normal(size=(6, 3)) * 0.5)
    bump_a = f32(rng.uniform(0.02, 0.06, size=(6,)))
    noise = f32(rng.uniform(0.1, 1.0, size=(8, 8, 8, 3)))
    bg_lat = f32(rng.uniform(0.15, 0.85, size=(9, 9, 3)))
    jit_rng = np.random.default_rng(seed + 101)
    fpx = 1.2 * res
    light = f32(LIGHT)

    grid = torch.arange(res, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(grid, grid, indexing="ij")  # pixel indices
    dirs = torch.stack([(px + 0.5 - res / 2) / fpx, (py + 0.5 - res / 2) / fpx,
                        torch.ones_like(px)], -1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)

    def bg_frame(ti):
        if background != "textured":
            return torch.ones((res, res, 3), device=device)
        # a slow pan, ~0.15 px per frame at res 64
        u = torch.remainder(px / res * 8.0 + 0.02 * ti, 8.0)
        v = torch.remainder(py / res * 8.0 + 0.01 * ti, 8.0)
        i, j = torch.floor(u).long(), torch.floor(v).long()
        fu, fv = (u - i)[..., None], (v - j)[..., None]
        return (bg_lat[j, i] * (1 - fu) * (1 - fv) + bg_lat[j, i + 1] * fu * (1 - fv)
                + bg_lat[j + 1, i] * (1 - fu) * fv + bg_lat[j + 1, i + 1] * fu * fv)

    def sdf_canon(p):
        d = torch.linalg.vector_norm(p, dim=-1) - R0
        b = torch.sum(bump_a * torch.exp(
            -torch.sum((p[..., None, :] / R0 - bump_c) ** 2, dim=-1) * 4.0), dim=-1)
        return d - b * R0

    def texture(p):
        u = torch.clamp((p / (2.2 * R0) + 0.5) * 7.0, 0.0, 6.999)
        return _trilinear(noise, u)

    frames, masks, depths = [], [], []
    for ti in range(n_frames):
        breathe = 1.0 + 0.1 * np.sin(0.5 * motion_scale * ti)
        rot = y_rotation(0.08 * motion_scale * ti)
        center = np.array([0.0, 0.0, CENTER_Z], np.float32)
        if cam_jitter > 0:
            w = jit_rng.normal(0, cam_jitter, size=3).astype(np.float32)
            wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float32)
            th = np.linalg.norm(w) + 1e-9
            rj = (np.eye(3, dtype=np.float32) + np.sin(th) / th * wx
                  + (1 - np.cos(th)) / th ** 2 * (wx @ wx))
            rot = rj @ rot
            center = center + jit_rng.normal(0, 0.1 * cam_jitter, size=3).astype(np.float32)
        rot_t, center_t = f32(rot), f32(center)
        breathe_t = torch.tensor(breathe, dtype=torch.float32, device=device)

        def world_to_canon(p):
            return ((p - center_t) @ rot_t) / breathe_t

        def sdf_world(p):
            return sdf_canon(world_to_canon(p)) * breathe_t

        t = torch.full((res, res), 0.2, device=device)
        for _ in range(TRACE_STEPS):
            t = t + torch.clamp(sdf_world(dirs * t[..., None]), -0.05, 0.05)
        p = dirs * t[..., None]
        hit = torch.abs(sdf_world(p)) < HIT_EPS
        eps = 1e-3
        n = torch.stack([sdf_world(p + e) - sdf_world(p - e)
                         for e in (f32([eps, 0, 0]), f32([0, eps, 0]), f32([0, 0, eps]))], -1)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-6)
        lam = 0.35 + 0.65 * torch.clamp(-torch.sum(n * light, dim=-1), 0.0, 1.0)
        rgb_fg = texture(world_to_canon(p)) * lam[..., None]
        frames.append(torch.where(hit[..., None], rgb_fg, bg_frame(ti)).cpu().numpy())
        masks.append(hit.cpu().numpy())
        depths.append(torch.where(hit, t, 0.0).cpu().numpy())
    return (np.stack(frames).astype(np.float32), np.stack(masks).astype(np.float32),
            np.stack(depths))


def score_renders(rendered: Dict[str, np.ndarray], gt: np.ndarray, gt_masks: np.ndarray,
                  gt_depth: np.ndarray) -> Dict:
    """The JAX script's scores (`synthetic_e2e.py:396-446`), unrounded, of
    the renders of the first len(rendered["rendered"]) frames: PSNR and
    SSIM per frame and their means; the foreground PSNR over GT masks of
    more than 16 pixels; the RMSE of the alpha-normalised rendered depth
    where both the GT depth and the rendered alpha (> 0.5) say a surface
    exists (more than 16 pixels); the IoU of those two masks."""
    img = rendered["rendered"]
    n_eval = img.shape[0]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    psnrs = [float(psnr(t(img[i]), t(gt[i]))) for i in range(n_eval)]
    ssims = [float(ssim(t(img[i]).permute(2, 0, 1), t(gt[i]).permute(2, 0, 1)))
             for i in range(n_eval)]
    out = {"render_psnr_mean": float(np.mean(psnrs)), "render_psnr_per_frame": psnrs,
           "render_ssim_mean": float(np.mean(ssims))}
    fg_psnrs = []
    for i in range(n_eval):
        m = np.asarray(gt_masks[i]) > 0.5
        if m.sum() > 16:
            mse = float(np.mean((np.asarray(img[i])[m] - gt[i][m]) ** 2))
            fg_psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
    if fg_psnrs:
        out["render_psnr_fg_mean"] = float(np.mean(fg_psnrs))
    alpha_r = np.asarray(rendered["mask"])[..., 0]
    depth_r = np.asarray(rendered["depth"])[..., 0] / np.maximum(alpha_r, 1e-6)
    d_errs, ious = [], []
    for i in range(n_eval):
        gt_m, r_m = gt_depth[i] > 0, alpha_r[i] > 0.5
        both = gt_m & r_m
        if both.sum() > 16:
            d_errs.append(float(np.sqrt(np.mean((depth_r[i][both] - gt_depth[i][both]) ** 2))))
        ious.append(float(both.sum() / max((gt_m | r_m).sum(), 1)))
    if d_errs:
        out["render_depth_rmse"] = float(np.mean(d_errs))
    out["render_mask_iou"] = float(np.mean(ious))
    return out


def rounded(scores: Dict) -> Dict:
    """`score_renders`' numbers rounded as the JAX script writes them."""
    places = {"render_psnr_mean": 3, "render_ssim_mean": 4, "render_psnr_fg_mean": 3,
              "render_depth_rmse": 5, "render_mask_iou": 4}
    out = {k: round(v, places[k]) for k, v in scores.items() if k in places}
    out["render_psnr_per_frame"] = [round(p, 2) for p in scores["render_psnr_per_frame"]]
    return out


def save_side_by_side(path_prefix: str, frames) -> str:
    """The render | GT frames as a video (`utils/io.save_vid`), or, without
    imageio, as ``<path_prefix>.npy`` (M, H, 2W, 3). Returns the path."""
    try:
        import imageio  # noqa: F401
    except ImportError:
        path = f"{path_prefix}.npy"
        np.save(path, np.stack(frames))
        print(f"imageio is not installed: wrote {path} instead of a video", flush=True)
        return path
    from vidu4d_tpu_torch.utils.io import save_vid

    return save_vid(path_prefix, frames)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "vidu4d_e2e"))
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--s2_rounds", type=int, default=3)
    ap.add_argument("--s2_iters", type=int, default=60)
    ap.add_argument("--s3_rounds", type=int, default=4)
    ap.add_argument("--s3_iters", type=int, default=100)
    ap.add_argument("--motion_scale", type=float, default=1.0,
                    help="multiplies the GT rotation/breathing rates; 2.0 pushes delta-1 "
                         "flow above the RAFT noise floor")
    ap.add_argument("--gt_source", default="surfel", choices=["surfel", "raymarch"],
                    help="surfel: the port's rasterizer renders the GT; raymarch: a "
                         "sphere-traced SDF GT independent of the rasterizer")
    ap.add_argument("--background", default="white", choices=["white", "textured"],
                    help="raymarch GT background: textured = cluttered panning noise")
    ap.add_argument("--cam_jitter", type=float, default=0.0,
                    help="per-frame random pose shake (radians) on the raymarch GT")
    ap.add_argument("--mask_source", default="gt", choices=["gt", "flow", "auto"],
                    help="masks fed to Stage 1: gt = perfect; flow = tracked from the GT "
                         "frame-0 seed; auto = the motion seed, tracked")
    ap.add_argument("--flow_wt", type=float, default=None,
                    help="override the Stage-3 flow loss weight (ablations)")
    ap.add_argument("--depth_wt", type=float, default=None)
    ap.add_argument("--raster_budget", type=int, default=512,
                    help="Stage-3 per-tile entry budget (taken and ignored: the kernel "
                         "path has none)")
    ap.add_argument("--s3_logname", default="s3",
                    help="Stage-3 logdir name, so runs sharing --out (and its Stage-1/2 "
                         "artifacts via --resume) train independent Stage-3 models")
    ap.add_argument("--resume", action="store_true",
                    help="skip stages whose artifacts exist in --out (Stage 3 resumes "
                         "from its latest checkpoint)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the four stages, write ``metrics.json`` (the JAX script's keys;
    ``metrics_<s3_logname>.json`` for another Stage-3 logname) and the
    render | GT frames. Returns the metrics, plus each stage's round
    seconds and the kernel launches of the run."""
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer
    from vidu4d_tpu_torch.preprocess.pipeline import preprocess_video, write_config
    from vidu4d_tpu_torch.utils.camera_trajectories import construct_batch

    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = train_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    metrics = {"config": vars(args)}
    launches0 = dict(kernels.COUNTS)
    t_all = time.time()

    # ---- ground-truth video (seeded: the same in every resumed run) ----
    if args.gt_source == "surfel":
        frames, masks, gt_depth = make_gt_video(args.res, args.frames,
                                                motion_scale=args.motion_scale, device=device)
    else:
        frames, masks, gt_depth = make_gt_video_raymarch(
            args.res, args.frames, motion_scale=args.motion_scale,
            background=args.background, cam_jitter=args.cam_jitter, device=device)
    gt_masks = masks  # the scores always use the true masks
    if args.mask_source != "gt":
        from vidu4d_tpu_torch.preprocess.segment import segment_video

        seed = masks[0] if args.mask_source == "flow" else None
        masks = segment_video(frames, seed_mask=seed, auto_seed=args.mask_source == "auto",
                              device=device)
        ious_m = [float(((masks[i] > .5) & (gt_masks[i] > .5)).sum()
                        / max(((masks[i] > .5) | (gt_masks[i] > .5)).sum(), 1))
                  for i in range(len(masks))]
        metrics["train_mask_iou_vs_gt"] = round(float(np.mean(ious_m)), 4)
        print(f"[masks:{args.mask_source}] IoU vs GT {metrics['train_mask_iou_vs_gt']}",
              flush=True)
    print(f"[gt:{args.gt_source}] frames {frames.shape} "
          f"coverage {np.asarray(masks).mean():.2f}", flush=True)

    # ---- stage 1 --------------------------------------------------------
    t0 = time.time()
    db = os.path.join(args.out, "database")
    if args.resume and os.path.exists(os.path.join(db, "configs", "synth.config")):
        print("[stage1] resume: database exists, skipping", flush=True)
    else:
        preprocess_video(frames, db, "synth-0000", masks=masks, crop_size=args.res,
                         delta_list=(1, 2, 4, 8), tsdf_grid=64, depths=gt_depth,
                         device=device)
        write_config(db, "synth", crop_size=args.res)
    metrics["stage1_s"] = round(time.time() - t0, 1)
    print(f"[stage1] {metrics['stage1_s']}s", flush=True)

    common = {"dataroot": db, "seqname": "synth", "logroot": os.path.join(args.out, "logdir"),
              "data_prefix": "crop", "train_res": args.res}

    # ---- stage 2 --------------------------------------------------------
    t0 = time.time()
    s2_dir = os.path.join(common["logroot"], "synth-s2")
    s2_ckpt = os.path.join(s2_dir, "ckpt_latest.pth")
    mesh = os.path.join(s2_dir, f"{args.s2_rounds - 1:03d}-fg-geo.obj")
    s2_rounds = []
    if args.resume and os.path.exists(s2_ckpt):
        print("[stage2] resume: checkpoint exists, skipping", flush=True)
    else:
        s2 = Stage2Trainer({
            **common, "logname": "s2", "pixels_per_image": 16, "imgs_per_gpu": 32,
            "num_rounds": args.s2_rounds, "iters_per_round": args.s2_iters,
            "save_freq": args.s2_rounds, "fg_motion": "bob", "field_depth": 4,
            "field_width": 128, "train_depth_samples": 32, "rgb_timefree": True,
            "rgb_dirfree": True, "iters_per_dispatch": 10,
        }, device=device)
        s2.mlp_init(sdf_iters=300, verbose=True)
        s2.train()
        s2_rounds = list(s2.round_seconds)
        del s2
    metrics["stage2_s"] = round(time.time() - t0, 1)
    print(f"[stage2] {metrics['stage2_s']}s mesh={os.path.exists(mesh)}", flush=True)

    # ---- stage 3 --------------------------------------------------------
    t0 = time.time()
    s3 = Stage3Trainer({
        **common, "logname": args.s3_logname, "pixels_per_image": -1, "imgs_per_gpu": 1,
        "num_rounds": args.s3_rounds, "iters_per_round": args.s3_iters,
        # a checkpoint every 4 rounds: a crash resumes from the last one
        "save_freq": min(4, args.s3_rounds), "fg_motion": "gs-bob",
        "gs_capacity": 40000, "gs_init_samples": 20000, "sh_degree": 1,
        "raster_budget": args.raster_budget, "raster_tile_chunk": 4,
        "gs_init_mesh": mesh if os.path.exists(mesh) else "",
        "densify_from_iter": 50, "densification_interval": 100,
        "opacity_reset_interval": 10_000, "outlier_filtering_interval": 10_000,
        "cameras_extent": 0.3, "iters_per_dispatch": 10,
        **({"flow_wt": args.flow_wt} if args.flow_wt is not None else {}),
        **({"depth_wt": args.depth_wt} if args.depth_wt is not None else {}),
    }, device=device)
    s3_ckpt = os.path.join(s3.save_dir, "ckpt_latest.pth")
    if args.resume and os.path.exists(s3_ckpt):
        s3.load_checkpoint(s3_ckpt, reset_steps=False)
        print(f"[stage3] resume from round {s3.current_round}", flush=True)
    else:
        s3.load_stage2(s2_ckpt)
    s3.train()
    metrics["stage3_s"] = round(time.time() - t0, 1)
    print(f"[stage3] {metrics['stage3_s']}s alive={int(s3.surfels.num_alive())}", flush=True)

    # ---- reference-view renders, scored --------------------------------
    n_eval = min(args.frames - 1, 8)
    batch = construct_batch(inst_id=0, frameid_sub=np.arange(n_eval), eval_res=args.res,
                            field2cam=None, camera_int=None, crop2raw=None, device=device)
    rendered = s3.render_batch(batch, res=args.res)
    gt = frames[:n_eval]
    metrics.update(rounded(score_renders(rendered, gt, gt_masks, gt_depth)))
    metrics["total_s"] = round(time.time() - t_all, 1)

    suffix = "" if args.s3_logname == "s3" else f"_{args.s3_logname}"
    save_side_by_side(os.path.join(args.out, f"render_vs_gt{suffix}"),
                      [np.concatenate([r, g], axis=1) for r, g in zip(rendered["rendered"], gt)])
    with open(os.path.join(args.out, f"metrics{suffix}.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2), flush=True)
    launches = {k: v - launches0[k] for k, v in kernels.COUNTS.items()}
    print(f"[launches] {json.dumps(launches)}", flush=True)
    return {**metrics, "stage2_round_s": s2_rounds, "stage3_round_s": list(s3.round_seconds),
            "launches": launches}


if __name__ == "__main__":
    main()
