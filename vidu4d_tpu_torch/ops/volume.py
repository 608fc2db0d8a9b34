"""Volume rendering: ray sampling, alpha compositing, importance sampling
(`vidu4d_tpu/ops/volume.py`).

Uniform depths between near and far (not disparity), deltas scaled by the
unnormalised ray length, weights normalised by the ray's mask with the
KEY_FREEZE outputs integrated under detached weights, flow weighted by its
validity, per-field densities normalised into masks.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from vidu4d_tpu_torch.ops import global_batch
from vidu4d_tpu_torch.ops.geometry import linspace01
from vidu4d_tpu_torch.ops.numerics import safe_norm, safe_normalize
from vidu4d_tpu_torch.utils.profiler import span

# outputs that are never integrated along the ray (`volume.py:19`)
KEY_SKIP = ("density", "vis", "flow", "eikonal", "xy_reproj", "xyz_reproj",
            "gauss_density")
# outputs integrated under detached weights (`volume.py:22`)
KEY_FREEZE = ("cyc_dist", "xyz_cam", "skin_entropy")


def sample_cam_rays(hxy: torch.Tensor, Kinv: torch.Tensor, near_far: torch.Tensor,
                    n_depth: int = 64, depth: Optional[torch.Tensor] = None):
    """Points along camera rays (`volume.py:25`; the JAX version's jitter,
    ``perturb``, has no caller and is not ported).

    hxy (M, N, 3) homogeneous pixels, Kinv (M, 3, 3), near_far (M, 2);
    ``depth`` (M, N, D, 1) replaces the uniform depths.
    Returns xyz (M, N, D, 3), unit directions (M, N, D, 3), deltas
    (M, N, D, 1), depth (M, N, D, 1)."""
    direction = torch.einsum("mni,mji->mnj", hxy, Kinv)
    dir_norm = safe_norm(direction, dim=-1)
    m, n = hxy.shape[:2]
    if depth is None:
        z = linspace01(n_depth, device=hxy.device, dtype=hxy.dtype)
        depth = near_far[:, 0:1] * (1 - z)[None] + near_far[:, 1:2] * z[None]  # (M, D)
        depth = depth[:, None, :, None].expand(m, n, n_depth, 1)
    xyz = direction[:, :, None, :] * depth
    deltas = depth[:, :, 1:] - depth[:, :, :-1]
    deltas = torch.cat([deltas, deltas[:, :, -1:]], dim=-2)
    deltas = deltas * dir_norm[:, :, None, None]
    unit_dir = direction / torch.clamp(dir_norm[..., None], min=1e-12)
    return xyz, unit_dir[:, :, None, :].expand(xyz.shape), deltas, depth


def compute_weights(density: torch.Tensor, deltas: torch.Tensor):
    """Volume-rendering weights and the transmittance after each sample
    (`volume.py:72`). density, deltas (M, N, D, 1) -> (M, N, D) each."""
    tau = (deltas * density)[..., 0]
    alpha = 1.0 - torch.exp(-tau)
    transmit = torch.exp(-torch.cumsum(tau, dim=-1))
    transmit_before = torch.cat([torch.ones_like(transmit[..., :1]), transmit[..., :-1]],
                                dim=-1)
    return alpha * transmit_before, transmit


def integrate(field_dict: Dict[str, torch.Tensor], weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Integrate the field outputs over each ray (`volume.py:87`)."""
    rendered = {}
    mask = torch.sum(weights, dim=-1, keepdim=True)
    rendered["mask"] = mask
    w_norm = weights / (mask + 1e-6)
    for k, v in field_dict.items():
        if k in KEY_SKIP:
            continue
        wt = w_norm.detach() if k in KEY_FREEZE else w_norm
        rendered[k] = torch.sum(wt[..., None] * v, dim=-2)
    if "flow" in field_dict:
        flow = field_dict["flow"]
        w_flow = weights * flow[..., 2]
        w_flow = w_flow / (torch.sum(w_flow, dim=-1, keepdim=True) + 1e-6)
        rendered["flow"] = torch.sum(w_flow[..., None] * flow[..., :2], dim=-2)
    if "normal" in rendered:
        rendered["normal"] = safe_normalize(rendered["normal"])
    density_keys = [k for k in rendered if k.startswith("density_")]
    if density_keys:
        total = sum(rendered[k] for k in density_keys) + 1e-6
        for k in density_keys:
            rendered["mask_" + k[len("density_"):]] = rendered[k] / total
            del rendered[k]
    return rendered


@span("s2.render")
def render_pixel(field_dict: Dict[str, torch.Tensor], deltas: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-pixel rendering with the visibility, eikonal, delta-skin and
    gauss-mask outputs (`volume.py:121`). "vis" is the visibility BCE
    weighted by the detached transmittance over its detached mean over the
    whole batch (`global_batch.mean_detached`: the global batch when the
    ranks split it); that mean is also returned as "vis_norm" (0-d), so
    that a render made in chunks of rays can be joined into the whole
    one's."""
    weights, transmit = compute_weights(field_dict["density"], deltas)
    rendered = integrate(field_dict, weights)
    if "eikonal" in field_dict:
        rendered["eikonal"] = torch.mean(field_dict["eikonal"], dim=(-1, -2))
    if "delta_skin" in field_dict:
        rendered["delta_skin"] = torch.mean(field_dict["delta_skin"], dim=(-1, -2))
    transmit_d = transmit.detach()[..., None]
    vis_loss = -torch.mean(F.logsigmoid(field_dict["vis"]) * transmit_d, dim=-2)
    rendered["vis_norm"] = global_batch.mean_detached(transmit_d)
    rendered["vis"] = vis_loss / rendered["vis_norm"]
    if "gauss_density" in field_dict:
        gauss_w, _ = compute_weights(field_dict["gauss_density"], deltas)
        rendered["gauss_mask"] = torch.sum(gauss_w, dim=-1, keepdim=True)
    return rendered


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF importance sampling (`volume.py:149`): bins (R, S - 1)
    depth midpoints, weights (R, S - 2) -> (R, n_importance) depths.
    ``det`` samples the CDF at evenly spaced levels, else at uniform draws
    from ``generator``."""
    n_rays, n_samples = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if det:
        u = linspace01(n_importance, device=bins.device, dtype=bins.dtype)
        u = u[None].expand(n_rays, n_importance).contiguous()
    else:
        u = torch.rand((n_rays, n_importance), generator=generator, device=bins.device,
                       dtype=bins.dtype)
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_samples)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    last = bins.shape[1] - 1
    bin_lo = torch.gather(bins, 1, torch.clamp(below, max=last))
    bin_hi = torch.gather(bins, 1, torch.clamp(above, max=last))
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)
