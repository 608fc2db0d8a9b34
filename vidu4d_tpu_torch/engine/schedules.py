"""Loss-weight / annealing schedules (`vidu4d_tpu/engine/schedules.py`;
host-side, pure numpy).

The Stage-3 trainer reads the 2DGS regulariser switch from
`progress_schedule`: the normal and distortion weights turn on after 8k
steps.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def interp_wt(x, y, x2, type: str = "linear") -> float:
    """Map scalar x2 from range x=[x0,x1] to y=[y0,y1], clipped to y."""
    x0, x1 = x
    y0, y1 = y
    if type == "linear":
        y2 = y0 + (x2 - x0) * (y1 - y0) / (x1 - x0)
    elif type == "log":
        log_y2 = np.log10(y0) + (x2 - x0) * (np.log10(y1) - np.log10(y0)) / (x1 - x0)
        y2 = 10 ** log_y2
    else:
        raise ValueError(type)
    return float(np.clip(y2, min(y0, y1), max(y0, y1)))


def progress_schedule(config: Dict, current_steps: int) -> Dict[str, float]:
    """All step-dependent scalars of one training step (`schedules.py:29`):
    alpha (PE annealing), beta_prob (inst-code swap probability) and the
    annealed ``<loss>_wt`` / ``lambda_*`` weights."""
    out = {}
    out["alpha"] = min(interp_wt((0, 4000), (0.6, 1.0), current_steps), 1.0)
    out["beta_prob"] = interp_wt((0, 2000), (1.0, 0.2), current_steps)
    if config["reg_cam_prior_wt"] > 1:
        cam_fac = interp_wt((0, 4000), (1.0, 0.1), current_steps)
    else:
        cam_fac = interp_wt((0, 800), (1.0, 0.0), current_steps)
    out["reg_cam_prior_wt"] = config["reg_cam_prior_wt"] * cam_fac
    out["reg_eikonal_wt"] = config["reg_eikonal_wt"] * interp_wt(
        (0, 4000), (1.0, 100.0), current_steps, type="log")
    out["reg_skel_prior_wt"] = config["reg_skel_prior_wt"] * interp_wt(
        (0, 4000), (1.0, 0.0), current_steps)
    out["reg_gauss_mask_wt"] = config["reg_gauss_mask_wt"] * interp_wt(
        (0, 4000), (1.0, 0.0), current_steps)
    # 2DGS regularisers switch on after 8k steps
    out["lambda_normal"] = config["lambda_normal"] if current_steps > 8000 else 0.0
    out["lambda_dist"] = config["lambda_dist"] if current_steps > 8000 else 0.0
    return out
