"""Quantitative evaluation command line (`vidu4d_tpu/metrics.py`; the
reference's `gs/metrics.py:49-100`): PSNR / SSIM / LPIPS over rendered vs
ground-truth image directories.

    python -m vidu4d_tpu_torch.metrics --pred_dir renders/ --gt_dir gt/ [--device cpu]

Prints one JSON object. LPIPS from the pinned random fallback is reported
under ``lpips_random`` and ``lpips`` is null, unless pretrained weights are
given ($VIDU4D_LPIPS_NPZ).
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch import config


def load_images(d: str):
    """The ``*.png`` then ``*.jpg`` files of ``d``, sorted, as float32 in
    [0, 1] (`utils.io.read_image`)."""
    from vidu4d_tpu_torch.utils.io import read_image

    paths = sorted(glob.glob(os.path.join(d, "*.png")) + glob.glob(os.path.join(d, "*.jpg")))
    return [read_image(p).astype(np.float32) / 255.0 for p in paths]


@torch.no_grad()
def compute_metrics(preds, gts, device="cuda"):
    """Mean PSNR / SSIM / LPIPS of (H, W, C) image pairs, on ``device``
    (`metrics.py:33`), with the JAX package's keys."""
    from vidu4d_tpu_torch.ops.image_losses import psnr, ssim
    from vidu4d_tpu_torch.ops.lpips import PRETRAINED, lpips, lpips_kind

    psnrs, ssims, lpipss = [], [], []
    for p, g in zip(preds, gts):
        p = torch.as_tensor(np.asarray(p)[..., :3], dtype=torch.float32, device=device)
        g = torch.as_tensor(np.asarray(g)[..., :3], dtype=torch.float32, device=device)
        p_t, g_t = p.permute(2, 0, 1), g.permute(2, 0, 1)
        psnrs.append(float(psnr(p_t, g_t)))
        ssims.append(float(ssim(p_t, g_t)))
        lpipss.append(lpips(p, g))
    kind = lpips_kind()
    mean_lpips = float(np.mean(lpipss))
    return {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": mean_lpips if kind == PRETRAINED else None,
        "lpips_random": None if kind == PRETRAINED else mean_lpips,
        "lpips_kind": kind,
        "n_images": len(psnrs),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from vidu4d_tpu_torch.gs_static import require_device

    opts = config.parse_flags(sys.argv[1:] if argv is None else argv,
                              extra=config.METRICS_FLAGS)
    device = require_device(opts["device"])
    preds = load_images(opts["pred_dir"])
    gts = load_images(opts["gt_dir"])
    if not preds or len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predicted and {len(gts)} ground-truth images")
    result = compute_metrics(preds, gts, device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
