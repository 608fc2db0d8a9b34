"""Camera-registration error of each depth source
(`scripts/eval_depth_registration.py`): the end metric of the monodepth
slot.

Stage 1 uses the depth prior only in its camera registration (the pair
loop of `pipeline.preprocess_video` -> `two_frame_registration_np`), so
the error of that registration is the metric that matters. The scene: a
rigidly rotating textured surfel blob (0.08 rad per frame about y, static
camera, no breathing) rendered by the port's rasterizer (the forward tile
kernel on the card), whose rotation between frames is known. For the GT
depth, DepthNet's and the flow parallax's, the pair registration and its
chain run on RAFT's flow and report the geodesic rotation errors.

    python -m vidu4d_tpu_torch.preprocess.eval_depth_registration \\
        --res 64 --frames 8 [--out errors.json] [--device cpu]

The flags and defaults are the JAX script's, plus ``--device`` (the card
unless "cpu"). The splats' rotations are ``rotations`` (the JAX script's
come from ``PRNGKey(0)`` inside ``init_from_points``), else drawn from a
``torch.Generator`` seeded with the scene's seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch.examples.synthetic_e2e import blob_splats, render_blob, y_rotation
from vidu4d_tpu_torch.preprocess.depth import estimate_depth
from vidu4d_tpu_torch.preprocess.flow import compute_flow_pairs
from vidu4d_tpu_torch.preprocess.registration import chain_poses, two_frame_registration_np
from vidu4d_tpu_torch.preprocess.train_common import train_device


def make_rigid_scene(res: int, n_frames: int, n_splats: int = 500, seed: int = 3,
                     rotations: Optional[torch.Tensor] = None, device="cuda"):
    """The blob of `synthetic_e2e.blob_splats` turning 0.08 rad per frame
    about y at depth 0.5, rendered by `render_blob`: (frames, masks alpha >
    0.3 float32, depth, Kinv (3, 3)) numpy."""
    state = blob_splats(n_splats, seed, rotations)
    xyz0 = state.params.xyz.numpy()
    xyz_frames = [xyz0 @ y_rotation(0.08 * t).T + np.array([0, 0, 0.5], np.float32)
                  for t in range(n_frames)]
    frames, alpha, depth = render_blob(state, xyz_frames, res, device)
    f = 1.2 * res
    kinv = np.array([[1 / f, 0, -res / 2 / f], [0, 1 / f, -res / 2 / f], [0, 0, 1]],
                    np.float32)
    return frames, (alpha > 0.3).astype(np.float32), depth, kinv


def rot_geodesic_deg(r_a: np.ndarray, r_b: np.ndarray) -> float:
    c = (np.trace(r_a.T @ r_b) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def registration_errors(depth, flow_fw, masks, kinv, ang_step: float = 0.08) -> Dict:
    """Each adjacent pair's registration (masked to the non-occluded
    foreground) against the true rotation, and the chained last pose
    against the whole turn, in degrees (rounded to 3 places)."""
    n = depth.shape[0] - 1
    r_gt = y_rotation(ang_step, np.float64)
    pair_errs, mats = [], []
    for i in range(n):
        m = masks[i] * (flow_fw[i, ..., 2] < 0.5)
        rt = two_frame_registration_np(depth[i], depth[i + 1], flow_fw[i, ..., :2], kinv,
                                       kinv, m)
        mats.append(rt)
        pair_errs.append(rot_geodesic_deg(rt[:3, :3], r_gt))
    chained = chain_poses(torch.as_tensor(np.stack(mats))).numpy()
    # chain_poses gives frame-0 -> frame-i transforms: compare the last
    chain_err = rot_geodesic_deg(chained[-1][:3, :3],
                                 y_rotation(ang_step * n, np.float64))
    return {"pair_rot_err_deg_mean": round(float(np.mean(pair_errs)), 3),
            "pair_rot_err_deg_max": round(float(np.max(pair_errs)), 3),
            "chained_rot_err_deg": round(chain_err, 3)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         rotations: Optional[torch.Tensor] = None) -> Dict:
    """Render the scene, flow by RAFT (`compute_flow_pairs`), depth by each
    source; returns {source: `registration_errors`} for "gt_depth",
    "depthnet" (`estimate_depth` "auto") and "flow_parallax", and writes
    it to ``--out`` when given."""
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = train_device(args.device)
    frames, masks, gt_depth, kinv = make_rigid_scene(args.res, args.frames,
                                                     rotations=rotations, device=device)
    flow_fw, _ = compute_flow_pairs(torch.as_tensor(frames, device=device), delta=1)
    flow_fw = flow_fw.cpu().numpy()
    results = {"gt_depth": registration_errors(gt_depth, flow_fw, masks, kinv)}
    for name, backend in (("depthnet", "auto"), ("flow_parallax", "flow_parallax")):
        depth = estimate_depth(frames, backend=backend, device=device).astype(np.float32)
        results[name] = registration_errors(depth, flow_fw, masks, kinv)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(results, fp, indent=2)
    return results


if __name__ == "__main__":
    main()
