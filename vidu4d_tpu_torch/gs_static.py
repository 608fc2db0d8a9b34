"""Static-scene 2DGS command line (`vidu4d_tpu/gs_static.py`, the reference's
`gs/train.py` + `gs/render.py`).

Train a static Gaussian-surfel scene from a COLMAP or Blender dataset:

    python -m vidu4d_tpu_torch.gs_static --source_path_ <scene> --model_path_ out/ \\
        --iterations 30000 [--device cpu]

Writes ``point_cloud.ply``, ``history.json`` (its last entry with the eval
PSNR / SSIM / LPIPS over every ``len // 8``-th training camera) and the TSDF
mesh ``fused_mesh.obj`` into ``--model_path_``. Runs on the card unless
``--device cpu``; without a card it raises.

The JAX CLI's quirks are kept: ``lambda_dssim`` is ``flag or 0.2`` (the
flag's default 0.0 gives 0.2); the learning rates, the raster options and
``sh_increase_interval`` are not read from flags; RGBA images are
composited onto white; at ``--downscale > 1`` the mesh is extracted from
the full-resolution intrinsics of every 4th camera in a frame cut to
``h // downscale, w // downscale``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch import config


def require_device(device: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a host without one
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available on this host "
                           "(pass --device cpu to run on the CPU)")
    return dev


def load_camera(scene_cam, downscale: int = 1, device="cpu"):
    """A scene-reader camera -> a trainer `Camera` on ``device``: the image
    in [0, 1] (RGBA onto white), strided by ``downscale``, the intrinsics
    divided by it (`gs_static.py:29`)."""
    from vidu4d_tpu_torch.engine.gs_trainer import Camera
    from vidu4d_tpu_torch.utils.io import read_image

    img = read_image(scene_cam.image_path).astype(np.float32) / 255.0
    if img.shape[-1] == 4:
        img = img[..., :3] * img[..., 3:] + (1 - img[..., 3:])
    if downscale > 1:
        img = img[::downscale, ::downscale]
    intr = scene_cam.intrins / downscale
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return Camera(viewmat=t(scene_cam.viewmat), intrins=t(intr), image=t(img))


def main(argv: Optional[Sequence[str]] = None) -> None:
    from vidu4d_tpu_torch.data.scene_readers import read_scene
    from vidu4d_tpu_torch.engine.gs_trainer import GsTrainConfig, bg_color, train
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.models.gaussian.extract import extract_mesh
    from vidu4d_tpu_torch.models.gaussian.ply_io import save_ply
    from vidu4d_tpu_torch.ops.image_losses import psnr, ssim
    from vidu4d_tpu_torch.ops.lpips import lpips, lpips_kind
    from vidu4d_tpu_torch.ops.rasterize import rasterize

    opts = config.parse_flags(sys.argv[1:] if argv is None else argv,
                              extra=config.GS_STATIC_FLAGS)
    device = require_device(opts.pop("device"))
    scene = read_scene(opts["source_path_"])
    cams = [load_camera(c, opts["downscale"], device) for c in scene.train_cameras]
    out_dir = opts["model_path_"]
    os.makedirs(out_dir, exist_ok=True)

    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    state = sf.init_from_points(
        as_t(scene.points), as_t(scene.colors), opts["gs_capacity"],
        sh_degree=opts["sh_degree"], generator=torch.Generator(device=device).manual_seed(0),
    )
    cfg = GsTrainConfig(
        iterations=opts["iterations"],
        lambda_dssim=opts["lambda_dssim"] or 0.2,
        sh_degree=opts["sh_degree"],
        densification_interval=opts["densification_interval"],
        opacity_reset_interval=opts["opacity_reset_interval"],
        densify_from_iter=opts["densify_from_iter"],
        densify_until_iter=opts["densify_until_iter"],
        densify_grad_threshold=opts["densify_grad_threshold"],
        percent_dense=opts["percent_dense"],
        white_background=opts["white_background"],
    )
    viewer = None
    if opts["gui_ip"]:
        from vidu4d_tpu_torch.utils.network_gui import ViewerServer

        viewer = ViewerServer(opts["gui_ip"], opts["gui_port"],
                              source_path=opts["source_path_"])
    try:
        state, _, history = train(state, cams, cfg, scene_extent=scene.extent,
                                  generator=torch.Generator().manual_seed(0),
                                  log_every=100, viewer=viewer)
    finally:
        if viewer is not None:
            viewer.close()
    save_ply(os.path.join(out_dir, "point_cloud.ply"),
             sf.SurfelParams(*[x.detach().cpu().numpy() for x in state.params]),
             state.alive.cpu().numpy())

    # final eval over the training views: PSNR / SSIM / LPIPS
    # (`gs/metrics.py:49-100`)
    p = state.params
    final = {"psnr": [], "ssim": [], "lpips": []}
    with torch.no_grad():
        for cam in cams[::max(1, len(cams) // 8)]:
            h, w = cam.image.shape[:2]
            out = rasterize(
                p.xyz, sf.get_rotation(p), sf.get_scaling(p), sf.get_opacity(p)[:, 0],
                cam.viewmat, cam.intrins, h, w, shs=sf.get_features(p),
                sh_degree=cfg.sh_degree, bg_color=bg_color(cfg, device), mask=state.alive,
                config=cfg.raster,
            )
            pred = torch.clamp(out.color, 0, 1)
            p_t, g_t = pred.permute(2, 0, 1), cam.image.permute(2, 0, 1)
            final["psnr"].append(float(psnr(p_t, g_t)))
            final["ssim"].append(float(ssim(p_t, g_t)))
            final["lpips"].append(lpips(pred, cam.image))
    if history:
        history[-1].update(
            eval_psnr=float(np.mean(final["psnr"])),
            eval_ssim=float(np.mean(final["ssim"])),
            eval_lpips=float(np.mean(final["lpips"])),
            lpips_kind=lpips_kind(),
        )
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(history, f)

    if opts["extract_mesh"] and scene.train_cameras:
        h = scene.train_cameras[0].height // opts["downscale"]
        w = scene.train_cameras[0].width // opts["downscale"]
        extract_mesh(p, state.alive, scene.train_cameras[::4], h, w,
                     out_path=os.path.join(out_dir, "fused_mesh.obj"))
    print(f"done; artifacts in {out_dir}")


if __name__ == "__main__":
    main()
