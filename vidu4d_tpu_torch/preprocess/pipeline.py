"""Stage-1 preprocessing orchestrator (`vidu4d_tpu/preprocess/pipeline.py`).

One call turns raw frames (with optional masks or depth) into the on-disk
contract the trainers read:

    database/processed/{JPEGImages,Annotations,FlowFW_d,FlowBW_d,Depth,
                        Features,Cameras}/Full-Resolution/<seq>/...
    database/configs/<collection>.config

Segmentation, crops, flow, depth, features, TSDF fusion and the canonical
fit run on ``device`` (default "cuda"); the per-pair Procrustes loop and
the PCA run on the host in numpy, as in JAX.

Frames on disk: with imageio installed, ``%05d.jpg`` as JAX writes them;
without it, ``%05d.png`` through `utils/io.write_png`. `write_config`
counts the .jpg frames, else the .png ones. Decoding a video needs
imageio and says so when it is missing.
"""

from __future__ import annotations

import configparser
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from vidu4d_tpu_torch.ops.geometry import K2inv, K2mat
from vidu4d_tpu_torch.ops.marching import save_obj
from vidu4d_tpu_torch.preprocess import ops as pops
from vidu4d_tpu_torch.preprocess.canonical import canonical_registration
from vidu4d_tpu_torch.preprocess.depth import estimate_depth
from vidu4d_tpu_torch.preprocess.features import extract_video_features
from vidu4d_tpu_torch.preprocess.flow import compute_flow_pairs, lk_flow
from vidu4d_tpu_torch.preprocess.registration import chain_poses, two_frame_registration_np
from vidu4d_tpu_torch.preprocess.tsdf import (
    fuse_tsdf,
    recenter_mesh_and_cams,
    tsdf_to_mesh,
    view_frustum_points,
)
from vidu4d_tpu_torch.utils.io import read_image, write_png


def _imageio():
    """imageio's v2 interface, or None when it is not installed."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    return imageio


def extract_frames(video_path: str, out_dir: str, skip_black: bool = True) -> np.ndarray:
    """Decode a video to ``%05d.jpg`` files and return (T, H, W, 3) floats
    in [0, 1], leading black frames skipped (`pipeline.py:52`). Needs
    imageio."""
    imageio = _imageio()
    if imageio is None:
        raise ImportError(f"decoding the video {video_path} needs imageio, which is not "
                          "installed; pass decoded frames to preprocess_video instead")
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for frame in imageio.get_reader(video_path):
        if skip_black and not frames and frame.max() < 10:
            continue
        frames.append(frame)
    for i, frame in enumerate(frames):
        imageio.imwrite(os.path.join(out_dir, f"{i:05d}.jpg"), frame)
    return np.stack(frames).astype(np.float32) / 255.0


def filter_frames(frames: np.ndarray, flow_threshold: float = 0.05, max_frames: int = 500,
                  min_frames: int = 8, work_res: int = 128, device="cuda") -> Optional[np.ndarray]:
    """Motion-based frame filter (`pipeline.py:69`): keep frame 0, then
    frame j iff the largest LK flow magnitude (at ``work_res`` squared,
    over the working resolution) from the last kept frame exceeds
    ``flow_threshold``; at most ``max_frames``. The kept indices, or None
    when no more than ``min_frames`` survive."""
    x = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    small = pops.resize_hwc(x, (work_res, work_res))

    def max_norm_flow(i0, i1):
        f = lk_flow(i0, i1) / float(work_res)
        return float(torch.sqrt(torch.clamp(torch.sum(f * f, dim=-1), min=1e-24)).max())

    keep, anchor = [0], 0
    for j in range(1, frames.shape[0]):
        if max_norm_flow(small[anchor], small[j]) > flow_threshold:
            keep.append(j)
            anchor = j
        if len(keep) >= max_frames:
            break
    if len(keep) <= min_frames:
        return None
    return np.asarray(keep, np.int64)


def _frame_paths(img_dir: str) -> List[str]:
    """The .jpg frames of a directory, else its .png ones, sorted."""
    return (sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
            or sorted(glob.glob(os.path.join(img_dir, "*.png"))))


def load_frames_dir(img_dir: str) -> np.ndarray:
    """(T, H, W, 3) floats in [0, 1] of a directory's frames (.jpg, else
    .png)."""
    return np.stack([read_image(p) for p in _frame_paths(img_dir)]).astype(np.float32) / 255.0


def center_box_mask(shape, frac: float = 0.6) -> np.ndarray:
    """Fallback foreground prior when no segmentation is available."""
    h, w = shape
    m = np.zeros((h, w), np.float32)
    dy, dx = int(h * (1 - frac) / 2), int(w * (1 - frac) / 2)
    m[dy:h - dy, dx:w - dx] = 1.0
    return m


def write_frames(frames: np.ndarray, out_dir: str) -> str:
    """Frames (T, H, W, 3) in [0, 1] as ``%05d.jpg`` through imageio, or
    ``%05d.png`` without it. Returns the extension written."""
    imageio = _imageio()
    ext = "jpg" if imageio is not None else "png"
    for i, frame in enumerate(frames):
        img = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
        path = os.path.join(out_dir, f"{i:05d}.{ext}")
        if imageio is not None:
            imageio.imwrite(path, img)
        else:
            write_png(path, img)
    return ext


def _lap(stats: Optional[dict], key: str, t0: float, device) -> float:
    """Record the seconds since ``t0`` under stats[key] (after the device
    finished); returns the clock."""
    if stats is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        stats.setdefault("seconds", {})[key] = time.perf_counter() - t0
    return time.perf_counter()


def preprocess_video(
    frames: np.ndarray,  # (T, H, W, 3) in [0, 1]
    out_root: str,
    seqname: str,
    masks: Optional[np.ndarray] = None,  # (T, H, W) float/bool fg masks
    crop_size: int = 256,
    delta_list=(1, 2, 4, 8),
    canonical_cams: Optional[Dict[int, np.ndarray]] = None,
    tsdf_grid: int = 96,
    depth_backend: str = "auto",
    depths: Optional[np.ndarray] = None,  # (T, H, W) external depth priors
    segment_backend: str = "external",
    device="cuda",
    stats: Optional[dict] = None,
) -> Dict[str, str]:
    """Run Stage 1 for one video and write its database files
    (`pipeline.py:131`). Returns {"root": out_root}.

    ``depths``: raw-resolution depth priors, else ``depth_backend``.
    ``segment_backend``: "external" takes ``masks`` as given (the centre
    prior when None); "flow" tracks masks[0] (or the centre prior) through
    the video; "auto" tracks the motion seed (`segment.motion_seed_mask`),
    the centre prior when its evidence is degenerate. ``stats``, when
    given, gets the backends taken ("seed", "flow", "depth", "features"),
    RAFT's chunk, and per stage the seconds ("seconds")."""
    t, hr, wr = frames.shape[:3]
    frames = np.asarray(frames, np.float32)

    def subdir(kind):
        d = os.path.join(out_root, "processed", kind, "Full-Resolution", seqname)
        os.makedirs(d, exist_ok=True)
        return d

    prefix = f"crop-{crop_size}"
    t_all = clock = time.perf_counter()
    if segment_backend in ("flow", "auto"):
        from vidu4d_tpu_torch.preprocess.segment import segment_video

        seed = np.asarray(masks[0]) if masks is not None else None
        masks = segment_video(frames, seed_mask=seed, auto_seed=segment_backend == "auto",
                              device=device, stats=stats)
        if stats is not None:
            stats["segment_flow"] = stats.pop("flow")
            stats["segment_raft_chunk"] = stats.pop("raft_chunk")
    elif masks is None:
        masks = np.stack([center_box_mask((hr, wr))] * t)
    masks = np.asarray(masks, np.float32)
    is_detected = (masks.reshape(t, -1).max(-1) > 0).astype(np.float32)
    clock = _lap(stats, "segment", clock, device)

    # raw intrinsics (`write_config.py:33-36`)
    max_l = float(max(hr, wr))
    k_raw = np.array([max_l, max_l, wr / 2.0, hr / 2.0], np.float32)

    # ---- crop params + resampling ---------------------------------------
    mask_t = torch.as_tensor(masks, device=device)
    c2r_t = pops.compute_crop_params(mask_t, crop_size=crop_size)
    rgb_c, mask_c, vis_c = [], [], []
    for img, mask, c2r in zip(frames, mask_t, c2r_t):
        rgb_c.append(pops.crop_resample(torch.as_tensor(img, device=device), c2r, crop_size))
        mask_c.append(pops.crop_resample(mask[..., None], c2r, crop_size, nearest=True)[..., 0])
        xrw, yrw = pops.crop_grid(c2r, crop_size)  # inside-raw-frame indicator
        vis_c.append(((xrw >= 0) & (xrw < wr) & (yrw >= 0) & (yrw < hr)).float())
    rgb_crop_t = torch.stack(rgb_c)
    rgb_crop = rgb_crop_t.cpu().numpy()
    mask_crop = torch.stack(mask_c).cpu().numpy()
    vis_crop = torch.stack(vis_c).cpu().numpy()
    crop2raw = c2r_t.cpu().numpy()

    np.save(os.path.join(subdir("JPEGImages"), f"{prefix}.npy"), rgb_crop.astype(np.float16))
    ann = np.stack([mask_crop, vis_crop], axis=-1).astype(np.float16)
    np.save(os.path.join(subdir("Annotations"), f"{prefix}.npy"), ann)
    np.save(os.path.join(subdir("Annotations"), f"{prefix}-crop2raw.npy"), crop2raw)
    np.save(os.path.join(subdir("Annotations"), f"{prefix}-is_detected.npy"), is_detected)
    # per-frame images (the render CLI reads frame counts from here)
    write_frames(frames, subdir("JPEGImages"))
    clock = _lap(stats, "crop", clock, device)

    # ---- flow at temporal deltas (`run_preprocess.py:85-88`) ------------
    for delta in delta_list:
        if delta >= t:
            continue
        fw, bw = compute_flow_pairs(rgb_crop_t, delta, stats=stats)
        # loader contract: row k of FlowFW_d is the pair (k*d, k*d + d)
        np.save(os.path.join(subdir(f"FlowFW_{delta}"), f"{prefix}.npy"),
                fw[::delta].cpu().numpy().astype(np.float16))
        np.save(os.path.join(subdir(f"FlowBW_{delta}"), f"{prefix}.npy"),
                bw[::delta].cpu().numpy().astype(np.float16))
        clock = _lap(stats, f"flow_{delta}", clock, device)

    # ---- depth ----------------------------------------------------------
    if depths is not None:
        dep = torch.as_tensor(np.asarray(depths, np.float32), device=device)
        depth = torch.stack([pops.crop_resample(d[..., None], c2r, crop_size)[..., 0]
                             for d, c2r in zip(dep, c2r_t)]).cpu().numpy()
    else:
        depth = estimate_depth(rgb_crop, backend=depth_backend, device=device, stats=stats)
    np.save(os.path.join(subdir("Depth"), f"{prefix}.npy"), depth)
    clock = _lap(stats, "depth", clock, device)

    # ---- features -------------------------------------------------------
    feats = extract_video_features(rgb_crop, masks=mask_crop, device=device, stats=stats)
    np.save(os.path.join(subdir("Features"), f"{prefix}-dinov2-01.npy"), feats)
    clock = _lap(stats, "features", clock, device)

    # ---- camera registration (bg=0, fg=1) -------------------------------
    k_crop = (K2inv(torch.as_tensor(crop2raw)) @ K2mat(torch.as_tensor(k_raw))).numpy()
    kinv_crop = np.linalg.inv(k_crop)
    fw1 = np.load(os.path.join(subdir("FlowFW_1"), f"{prefix}.npy")).astype(np.float32)
    cam_dir = subdir("Cameras")

    def pair_fit(i, comp_id):
        m = mask_crop[i] if comp_id == 1 else (1 - mask_crop[i])
        m = m * (fw1[i, ..., 2] < 0.5)  # drop occluded
        return two_frame_registration_np(depth[i], depth[i + 1], fw1[i, ..., :2],
                                          kinv_crop[i], kinv_crop[i + 1], m)

    # the host pairs are independent: numpy releases the GIL in their large
    # array operations, so they run in threads
    with ThreadPoolExecutor() as pool:
        for comp_id, comp_name in ((0, "00"), (1, "01")):
            pair_mats = list(pool.map(pair_fit, range(t - 1), [comp_id] * (t - 1)))
            cams = chain_poses(torch.as_tensor(np.stack(pair_mats))).numpy()
            np.save(os.path.join(cam_dir, f"{comp_name}.npy"), cams.astype(np.float32))
    clock = _lap(stats, "registration", clock, device)

    # ---- TSDF fusion of the fg component -> centred mesh + cams ---------
    cams_fg = np.load(os.path.join(cam_dir, "01.npy"))
    depth_masked = depth.astype(np.float32) * mask_crop
    cam2scene = np.linalg.inv(cams_fg)
    dm_t = torch.as_tensor(depth_masked, device=device)
    kinv_t = torch.as_tensor(kinv_crop, device=device)
    c2s_t = torch.as_tensor(cam2scene, device=device)
    corners = torch.cat([view_frustum_points(d, k, c) for d, k, c in zip(dm_t, kinv_t, c2s_t)])
    vol_bnds = torch.stack([corners.amin(0), corners.amax(0)])
    tsdf, _, weight = fuse_tsdf(dm_t, torch.as_tensor(rgb_crop, device=device), kinv_t,
                                c2s_t, vol_bnds, grid_size=tsdf_grid)
    clock = _lap(stats, "tsdf", clock, device)
    verts, faces = tsdf_to_mesh(tsdf, weight, vol_bnds)
    if len(verts):
        verts, cams_centered = recenter_mesh_and_cams(verts, cams_fg)
        save_obj(os.path.join(cam_dir, "mesh-01-centered.obj"), verts, faces)
        save_obj(os.path.join(cam_dir, "mesh-00-centered.obj"), verts, faces)
    else:
        cams_centered = cams_fg
    clock = _lap(stats, "marching_weld", clock, device)

    # ---- canonical registration (`canonical_registration.py:67-158`) ----
    if canonical_cams is None:
        canonical_cams = {0: cams_centered[0]}
    cams_canonical, _ = canonical_registration(canonical_cams, cams_centered, num_iter=500,
                                               device=device)
    # the reference discards the optimised translations and re-derives them
    # per frame from the mask bbox (`canonical_registration.py:130-152`):
    # z = focal / sqrt(bbox area), xy = z * (bbox centre - principal) /
    # focal, which keeps the object in front of every camera
    cams_canonical = np.array(cams_canonical)
    for i in range(t):
        ys, xs = np.nonzero(mask_crop[i] > 0)
        if len(xs) == 0:
            continue
        bw_, bh_ = float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)
        focal = float(k_crop[i][0, 0])
        z = min(focal / np.sqrt(max(bw_ * bh_, 1.0)), 10.0)
        cx, cy = float(k_crop[i][0, 2]), float(k_crop[i][1, 2])
        bcx = (float(xs.max()) + float(xs.min())) / 2.0
        bcy = (float(ys.max()) + float(ys.min())) / 2.0
        cams_canonical[i, 0, 3] = z * (bcx - cx) / focal
        cams_canonical[i, 1, 3] = z * (bcy - cy) / focal
        cams_canonical[i, 2, 3] = z
    np.save(os.path.join(cam_dir, "01-canonical.npy"), cams_canonical.astype(np.float32))
    _lap(stats, "canonical", clock, device)
    _lap(stats, "total", t_all, device)
    return {"root": out_root}


def write_config(out_root: str, collection_name: str, crop_size: int = 256):
    """database/configs/<collection>.config (`pipeline.py:340`): one
    section per sequence with at least 8 frames (.jpg, else .png)."""
    imgroot = os.path.join(out_root, "processed", "JPEGImages", "Full-Resolution")
    config = configparser.ConfigParser()
    config["data"] = {"init_frame": "0", "end_frame": "-1"}
    total = 0
    for seq in sorted(glob.glob(os.path.join(imgroot, f"{collection_name}-*"))):
        paths = _frame_paths(seq)
        if len(paths) < 8:
            continue
        img = read_image(paths[0])
        fl = max(img.shape[:2])
        config[f"data_{total}"] = {
            "ks": f"{fl} {fl} {img.shape[1] // 2} {img.shape[0] // 2}",
            "shape": f"{img.shape[0]} {img.shape[1]}",
            "img_path": seq + "/",
        }
        total += 1
    os.makedirs(os.path.join(out_root, "configs"), exist_ok=True)
    with open(os.path.join(out_root, "configs", f"{collection_name}.config"), "w") as f:
        config.write(f)


def run_preprocess(out_root: str, collection_name: str, video_paths: List[str],
                   masks_per_video: Optional[List[np.ndarray]] = None,
                   crop_size: int = 256, use_filter_frames: bool = False,
                   segment_backend: str = "external", device="cuda"):
    """Every video of a collection, then its config
    (`scripts/run_preprocess.py:122-235`); the frame filter is off by
    default, as upstream."""
    for vidid, path in enumerate(video_paths):
        seqname = f"{collection_name}-{vidid:04d}"
        frames = extract_frames(path, os.path.join(
            out_root, "processed", "JPEGImagesRaw", "Full-Resolution", seqname))
        masks = masks_per_video[vidid] if masks_per_video else None
        if use_filter_frames:
            keep = filter_frames(frames, device=device)
            if keep is None:
                print(f"lack of motion, ignored: {seqname}")
                continue
            frames = frames[keep]
            if masks is not None:
                masks = masks[keep]
        preprocess_video(frames, out_root, seqname, masks=masks, crop_size=crop_size,
                         segment_backend=segment_backend, device=device)
    write_config(out_root, collection_name, crop_size=crop_size)
