"""Loss assembly: reconstruction terms, mask rules and weighting
(`vidu4d_tpu/engine/losses.py`). The Stage-3 step uses the two helpers;
Stage 2's `DvrModel.loss` the whole chain.

The reductions over the batch go through `ops.global_batch`: when
data-parallel ranks split the batch, each is this rank's part of the
global batch's value (a local sum over the global count); otherwise the
plain reduction."""

from __future__ import annotations

from typing import Dict

import torch

from vidu4d_tpu_torch.ops import global_batch
from vidu4d_tpu_torch.ops.numerics import safe_norm

# masking rule groups (`losses.py:20-25`)
KEYS_IGNORE_MASKING = ("reg_gauss_mask",)
KEYS_ALLPIX = ("mask",)
KEYS_FG = ("feature", "feat_reproj")
KEYS_TYPE_SPECIFIC = ("rgb", "depth", "flow", "vis", "rgb_ssim")
KEYS_MASK_NOT_DETECTED = ("mask", "feature", "feat_reproj")
PX_UNIT_KEYS = ("flow", "feat_reproj")


def _per_frame(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(M,) -> (M, 1, ...) broadcastable against ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def get_mask_balance_wt(mask, vis2d, is_detected):
    """Balance positive/negative mask pixels (`losses.py:28`). The pixel
    counts and the ``usable`` test are sums over the (global) batch."""
    mask = mask.float()
    vis2d = vis2d.float() * _per_frame(is_detected.float(), mask)
    sums = torch.stack([torch.sum(mask * (vis2d > 0)), torch.sum((1 - mask) * (vis2d > 0)),
                        torch.sum(vis2d), torch.sum(mask), torch.sum(1 - mask)])
    pos_px, neg_px, total, n_pos, n_neg = global_batch.total(sums).unbind(0)
    pos_wt = total / torch.clamp(pos_px, min=1e-6)
    neg_wt = total / torch.clamp(neg_px, min=1e-6)
    balanced = 0.5 * pos_wt * mask + 0.5 * neg_wt * (1 - mask)
    usable = (n_pos > 0) & (n_neg > 0)
    return torch.where(usable, balanced, torch.ones_like(balanced))


def compute_recon_loss(rendered: Dict, aux_dict: Dict, batch: Dict, config: Dict) -> Dict:
    """Dense per-pixel reconstruction terms (`losses.py:45`), by
    ``config["field_type"]``: the balanced mask against the rendered mask
    ("fg"), the background's mask against 1 ("bg"), or both, the fg mask
    being the fg field's share "mask_fg" ("comp"); then the fg field's
    feature and its reprojection (fg, comp), rgb, depth, flow, visibility
    (the bg field's at 0.01) and the gauss-mask consistency."""
    field_type = config["field_type"]
    rendered_fg_mask = rendered["mask_fg"] if field_type == "comp" else rendered["mask"]
    loss_dict = {}
    balance = get_mask_balance_wt(batch["mask"], batch["vis2d"], batch["is_detected"])
    gt_mask = batch["mask"].float()
    if field_type == "bg":
        loss_dict["mask"] = (rendered["mask"] - 1.0) ** 2
    else:
        loss_dict["mask"] = ((rendered_fg_mask - gt_mask) ** 2) * balance
        if field_type == "comp":
            loss_dict["mask"] = loss_dict["mask"] + (rendered["mask"] - 1.0) ** 2
    fg_aux = aux_dict.get("fg", {})
    if "feature" in fg_aux and fg_aux["feature"].shape[-1] > 0:
        loss_dict["feature"] = safe_norm(fg_aux["feature"] - batch["feature"], dim=-1,
                                         keepdim=True)
    if "xy_reproj" in fg_aux:
        loss_dict["feat_reproj"] = safe_norm(fg_aux["xy_reproj"] - batch["hxy"][..., :2],
                                             dim=-1, keepdim=True)
    loss_dict["rgb"] = (rendered["rgb"] - batch["rgb"]) ** 2
    loss_dict["depth"] = safe_norm(rendered["depth"] - batch["depth"], dim=-1, keepdim=True)
    if "flow" in rendered and "flow" in batch:
        flow_l = safe_norm(rendered["flow"] - batch["flow"], dim=-1, keepdim=True)
        loss_dict["flow"] = flow_l * (batch["flow_uct"] > 0).to(flow_l.dtype)
    vis_terms = [a["vis"] * 0.01 if cate == "bg" else a["vis"]
                 for cate, a in aux_dict.items() if "vis" in a]
    if vis_terms:
        loss_dict["vis"] = sum(vis_terms)
    if "gauss_mask" in fg_aux:
        loss_dict["reg_gauss_mask"] = (fg_aux["gauss_mask"] - rendered_fg_mask.detach()) ** 2
    return loss_dict


def mask_losses(loss_dict: Dict, batch: Dict, config: Dict) -> Dict:
    """Segmentation-mask and detection rules (`losses.py:112`): the
    type-specific terms count on fg pixels ("fg"), bg pixels ("bg") or
    every visible pixel ("comp")."""
    vis2d = batch["vis2d"].float()
    maskfg = batch["mask"].float()
    mask = {"fg": maskfg * vis2d, "bg": (1 - maskfg) * vis2d, "comp": vis2d}[
        config["field_type"]]
    if config.get("no_loss_mask", False):
        mask, maskfg, vis2d = (torch.ones_like(mask), torch.ones_like(maskfg),
                               torch.ones_like(vis2d))
    out = {}
    for k, v in loss_dict.items():
        if config.get("maskloss_no_vis2d", False) and "mask" in k:
            out[k] = v * torch.where(vis2d == 0, 0.1, vis2d)
        elif k in KEYS_IGNORE_MASKING:
            out[k] = v
        elif k in KEYS_ALLPIX:
            out[k] = v * vis2d
        elif k in KEYS_FG:
            out[k] = v * maskfg
        elif k in KEYS_TYPE_SPECIFIC:
            out[k] = v * mask
        else:
            out[k] = v
    is_det = batch["is_detected"].float()
    for k in KEYS_MASK_NOT_DETECTED:
        if k in out:
            out[k] = out[k] * _per_frame(is_det, out[k])
    return out


def nonzero_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over strictly-positive entries; plain mean if none (of the
    global batch when the ranks split it)."""
    pos = (v > 0).to(v.dtype)
    cnt = global_batch.total(torch.sum(pos))
    return torch.where(cnt > 0,
                       global_batch.weighted(torch.sum(v * pos)) / torch.clamp(cnt, min=1.0),
                       global_batch.mean(v))


def apply_loss_weights(loss_dict: Dict, config: Dict, weight_overrides: Dict) -> Dict:
    """Reduce each dense term by `nonzero_mean`, divide the pixel-unit ones
    by train_res, scale by the annealed weight, else the configured one
    (`losses.py:160`)."""
    out = {}
    for k, v in loss_dict.items():
        val = nonzero_mean(v) if v.dim() > 0 else v
        if k in PX_UNIT_KEYS:
            val = val / config["train_res"]
        wt_name = k + "_wt"
        if wt_name in weight_overrides:
            val = val * weight_overrides[wt_name]
        elif wt_name in config:
            val = val * config[wt_name]
        out[k] = val
    return out
