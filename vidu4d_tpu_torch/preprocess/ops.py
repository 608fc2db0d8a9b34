"""Core image ops of Stage-1 preprocessing (`vidu4d_tpu/preprocess/ops.py`):
sampling, crop parameters and resampling, flow warps, the flow cycle
check, and `resize` with the semantics of ``jax.image.resize``.

Every function takes tensors on any device and returns tensors there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """Resize the last two axes of x (..., H, W) to ``size`` (h, w) as
    ``jax.image.resize`` does: "bilinear" uses half-pixel centres and, when
    it shrinks an axis, a triangle filter widened by the scale
    (antialiasing; ``F.interpolate(..., antialias=True)``); "nearest" takes
    source index floor((i + 0.5) * in / out) ("nearest-exact")."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    if (h, w) == tuple(size):
        return x
    flat = x.reshape((-1, 1, h, w))
    if method == "bilinear":
        out = F.interpolate(flat, size=tuple(size), mode="bilinear", align_corners=False,
                            antialias=True)
    elif method == "nearest":
        out = F.interpolate(flat, size=tuple(size), mode="nearest-exact")
    else:
        raise ValueError(f"resize method {method!r}: 'bilinear' or 'nearest'")
    return out.reshape(lead + tuple(size))


def resize_hwc(x: torch.Tensor, size, method: str = "bilinear") -> torch.Tensor:
    """`resize` of channels-last images (..., H, W, C)."""
    return resize(x.movedim(-1, -3), size, method).movedim(-3, -1)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at float pixel coordinates x, y (...,); clamps
    at the borders (`ops.py:17`).

    The coordinates clip to [0, w - 1.000001], which rounds to exactly
    w - 1 in float32 once w >= 256; then x0 + 1 == w. JAX clamps that
    out-of-range gather (its weight is 0); here the neighbour index is
    clamped to the last row / column, which gives the same value."""
    h, w = img.shape[:2]
    x = torch.clamp(x, 0.0, w - 1.000001)
    y = torch.clamp(y, 0.0, h - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)


def nearest_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (H, W, C) at the nearest pixel of x, y (`ops.py:39`); rounds half
    to even, as ``jnp.round`` does."""
    h, w = img.shape[:2]
    xi = torch.clamp(torch.round(x), 0, w - 1).long()
    yi = torch.clamp(torch.round(y), 0, h - 1).long()
    return img[yi, xi]


def compute_crop_params(mask: torch.Tensor, crop_factor: float = 1.2,
                        crop_size: int = 256, use_full: bool = False) -> torch.Tensor:
    """crop -> raw transform (..., 4) = (fx, fy, px, py) from the bbox of
    each mask (..., H, W) (`ops.py:46`); the full image where a mask is
    empty. No host sync: masked min / max, as in JAX."""
    h, w = mask.shape[-2:]
    if use_full:
        mask = torch.ones_like(mask)
        crop_factor = 1.0
    ys = torch.arange(h, dtype=torch.float32, device=mask.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=mask.device)[None, :]
    on = mask > 0
    any_on = on.flatten(-2).any(-1)

    def extreme(coords, fn, fill, empty):
        v = fn(torch.where(on, coords, fill).flatten(-2), dim=-1).values
        return torch.where(any_on, v, empty)

    x_min = extreme(xs, torch.min, 1e9, 0.0)
    x_max = extreme(xs, torch.max, -1e9, w - 1.0)
    y_min = extreme(ys, torch.min, 1e9, 0.0)
    y_max = extreme(ys, torch.max, -1e9, h - 1.0)
    cx = torch.floor((x_max + x_min) / 2.0)
    cy = torch.floor((y_max + y_min) / 2.0)
    lx = torch.floor(crop_factor * torch.floor((x_max - x_min) / 2.0))
    ly = torch.floor(crop_factor * torch.floor((y_max - y_min) / 2.0))
    return torch.stack([2.0 * lx / crop_size, 2.0 * ly / crop_size, cx - lx, cy - ly], dim=-1)


def crop_grid(crop2raw: torch.Tensor, crop_size: int):
    """Raw pixel coordinates (x, y), each (crop_size, crop_size), of the
    crop frame's pixels."""
    xs = torch.arange(crop_size, dtype=torch.float32, device=crop2raw.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    return gx * crop2raw[0] + crop2raw[2], gy * crop2raw[1] + crop2raw[3]


def crop_resample(img: torch.Tensor, crop2raw: torch.Tensor, crop_size: int,
                  nearest: bool = False) -> torch.Tensor:
    """Resample img (H, W, C) into the (crop_size, crop_size) crop frame
    (`ops.py:78`)."""
    x_raw, y_raw = crop_grid(crop2raw, crop_size)
    fn = nearest_sample if nearest else bilinear_sample
    return fn(img, x_raw, y_raw)


def pixel_grid(h: int, w: int, device=None):
    """(gx, gy), each (h, w) float32: the pixel coordinates."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return gx, gy


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img (H, W, C) by flow (H, W, 2) (`ops.py:90`)."""
    gx, gy = pixel_grid(img.shape[0], img.shape[1], img.device)
    return bilinear_sample(img, gx + flow[..., 0], gy + flow[..., 1])


def flow_to_crop(flow_raw: torch.Tensor, hp_raw: torch.Tensor, crop2raw_other: torch.Tensor,
                 hxy_crop: torch.Tensor) -> torch.Tensor:
    """Raw-coordinate flow into the crop frame (`ops.py:99`)."""
    target_raw = flow_raw + hp_raw[..., :2]
    fx, fy, px, py = crop2raw_other.unbind(-1)
    target_crop = torch.stack([(target_raw[..., 0] - px) / fx,
                               (target_raw[..., 1] - py) / fy], dim=-1)
    return target_crop - hxy_crop[..., :2]


def flow_cycle_uncertainty(occ: torch.Tensor, flow0_crop: torch.Tensor,
                           flow1_crop_warped_coords: torch.Tensor,
                           hxy: torch.Tensor) -> torch.Tensor:
    """Forward-backward cycle uncertainty (`ops.py:112`):
    exp(-25 * ||bw(fw(x)) - x|| / size * 2), 0 below 0.25 and where
    occluded."""
    img_size = occ.shape[0]
    cyc = warp_by_flow(flow1_crop_warped_coords, flow0_crop) - hxy[..., :2]
    dis = torch.sqrt(torch.clamp(torch.sum(cyc * cyc, dim=-1), min=1e-24))
    uct = torch.exp(-25.0 * dis / img_size * 2.0)
    uct = torch.where(uct < 0.25, 0.0, uct)
    return torch.where(occ > 0, 0.0, uct)
