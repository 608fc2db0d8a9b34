"""Learned monocular depth (`vidu4d_tpu/preprocess/depthnet.py`): the U-Net
trained in-repo on synthetic renders (the ZoeDepth slot), its training
losses and its weights file. Layout NCHW; the weights are the shipped flax
ones (`load_depthnet`), written back in their layout by `save_weights`.

Output convention (MiDaS): per-pixel disparity up to an affine map;
`disparity_to_depth` maps it into a depth range per image. The losses
(`depth_loss`: scale-shift-invariant MAE + multi-scale gradient matching,
`ranking_loss`: a pairwise ordinal hinge) take disparity (B, H, W).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vidu4d_tpu_torch.convert import flax_conv_net_flat
from vidu4d_tpu_torch.utils.io import savez_atomic
from vidu4d_tpu_torch.preprocess.layers import SameConv2d, group_norm, load_net, weights_path
from vidu4d_tpu_torch.preprocess.ops import resize

WEIGHTS_ENV, WEIGHTS_FILE = "VIDU4D_DEPTHNET_NPZ", "depthnet_synthetic.npz"


class ConvBlock(nn.Module):
    """conv (stride s) -> GroupNorm -> GELU -> conv -> GroupNorm -> GELU;
    flax's ``nn.gelu`` is the tanh approximation."""

    FLAX_NAMES = {"Conv_0": "conv1", "GroupNorm_0": "norm1", "Conv_1": "conv2",
                  "GroupNorm_1": "norm2"}

    def __init__(self, cin: int, feats: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = SameConv2d(cin, feats, 3, stride, device=device)
        self.norm1 = group_norm(feats, device=device)
        self.conv2 = SameConv2d(feats, feats, 3, device=device)
        self.norm2 = group_norm(feats, device=device)

    def forward(self, x):
        x = F.gelu(self.norm1(self.conv1(x)), approximate="tanh")
        return F.gelu(self.norm2(self.conv2(x)), approximate="tanh")


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))


class DepthNet(nn.Module):
    """U-Net: 4 stride-2 encoder stages (H/16 bottleneck), a skip-connected
    decoder and a 1-channel softplus disparity head (`depthnet.py:51`)."""

    FLAX_NAMES = {**{f"ConvBlock_{i}": f"blocks.{i}" for i in range(9)}, "Conv_0": "head"}

    def __init__(self, width: int = 32, device=None):
        super().__init__()
        w = width
        chans = [(3, w, 1), (w, 2 * w, 2), (2 * w, 3 * w, 2), (3 * w, 4 * w, 2),
                 (4 * w, 4 * w, 2),  # encoder, mid at H/16
                 (8 * w, 4 * w, 1), (7 * w, 3 * w, 1), (5 * w, 2 * w, 1), (3 * w, w, 1)]
        self.blocks = nn.ModuleList([ConvBlock(a, b, s, device=device) for a, b, s in chans])
        self.head = SameConv2d(w, 1, 3, device=device)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1], H and W multiples of 16 -> (B, H, W)
        nonnegative disparity."""
        b = self.blocks
        e1 = b[0](rgb)
        e2 = b[1](e1)
        e3 = b[2](e2)
        e4 = b[3](e3)
        mid = b[4](e4)
        d4 = b[5](torch.cat([_up2(mid), e4], dim=1))
        d3 = b[6](torch.cat([_up2(d4), e3], dim=1))
        d2 = b[7](torch.cat([_up2(d3), e2], dim=1))
        d1 = b[8](torch.cat([_up2(d2), e1], dim=1))
        return F.softplus(self.head(d1)[:, 0])


def disparity_to_depth(disp: torch.Tensor, lo: float = 0.5, hi: float = 4.0) -> torch.Tensor:
    """Relative disparity (..., H, W) -> depth in [lo, hi] per image
    (`depthnet.py:163`)."""
    d = disp - disp.amin(dim=(-2, -1), keepdim=True)
    d = d / torch.clamp(d.amax(dim=(-2, -1), keepdim=True), min=1e-6)
    inv_lo, inv_hi = 1.0 / hi, 1.0 / lo
    return 1.0 / (inv_lo + d * (inv_hi - inv_lo))


def align_affine(pred: torch.Tensor, gt: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image least-squares (s, t) with s * pred + t ~ gt over mask
    (`depthnet.py:79`): the closed form, s = 1 where the system is singular."""
    m = mask.reshape(mask.shape[0], -1)
    p = pred.reshape(pred.shape[0], -1) * m
    g = gt.reshape(gt.shape[0], -1) * m
    n = torch.clamp(m.sum(-1), min=1.0)
    sp, sg = p.sum(-1), g.sum(-1)
    spp, spg = (p * p).sum(-1), (p * g).sum(-1)
    det = n * spp - sp * sp
    s = torch.where(torch.abs(det) > 1e-8, (n * spg - sp * sg) / det, torch.ones_like(det))
    return s, (sg - s * sp) / n


def ssi_mae(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scale-shift-invariant MAE over the valid pixels (`depthnet.py:99`)."""
    s, t = align_affine(pred, gt, mask)
    err = torch.abs(s[:, None, None] * pred + t[:, None, None] - gt) * mask
    return err.sum() / torch.clamp(mask.sum(), min=1.0)


def gradient_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                  scales: int = 3) -> torch.Tensor:
    """Multi-scale gradient matching of the aligned residual (MiDaS eq. 11,
    `depthnet.py:107`)."""
    s, t = align_affine(pred, gt, mask)
    d = s[:, None, None] * pred + t[:, None, None] - gt
    total = 0.0
    for k in range(scales):
        step = 2 ** k
        dk, mk = d[:, ::step, ::step], mask[:, ::step, ::step]
        gx = torch.abs(torch.diff(dk, dim=2)) * mk[:, :, 1:] * mk[:, :, :-1]
        gy = torch.abs(torch.diff(dk, dim=1)) * mk[:, 1:] * mk[:, :-1]
        total = total + (gx.sum() + gy.sum()) / torch.clamp(mk.sum(), min=1.0)
    return total / scales


def depth_loss(pred_disp: torch.Tensor, gt_depth: torch.Tensor, mask: torch.Tensor,
               grad_wt: float = 0.5) -> torch.Tensor:
    """SSI-MAE + grad_wt x gradient matching against the disparity
    1 / max(depth, 1e-3) (`depthnet.py:124`)."""
    gt_disp = torch.where(mask > 0, 1.0 / torch.clamp(gt_depth, min=1e-3),
                          torch.zeros_like(gt_depth))
    return (ssi_mae(pred_disp, gt_disp, mask)
            + grad_wt * gradient_loss(pred_disp, gt_disp, mask))


def ranking_pairs(batch: int, hw: int, generator: torch.Generator, n_pairs: int = 768,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ranking_loss`'s pixel pairs: (ii, jj), each (batch, n_pairs) flat
    pixel indices in [0, hw)."""
    draw = lambda: torch.randint(0, hw, (batch, n_pairs), generator=generator, device=device)
    return draw(), draw()


def ranking_loss(pred_disp: torch.Tensor, gt_depth: torch.Tensor, mask: torch.Tensor,
                 ii: torch.Tensor, jj: torch.Tensor, margin: float = 0.05,
                 rel_tau: float = 0.03) -> torch.Tensor:
    """Pairwise ordinal hinge (DIW-style, `depthnet.py:131`) over the pixel
    pairs (ii, jj) (`ranking_pairs`; JAX draws them from its key): pairs
    whose depths differ by more than ``rel_tau`` relatively must have
    disparities ordered by at least ``margin`` of the image's disparity
    spread."""
    b = pred_disp.shape[0]
    pd, gd, mm = pred_disp.reshape(b, -1), gt_depth.reshape(b, -1), mask.reshape(b, -1)
    ii, jj = ii.long(), jj.long()
    pi, pj = torch.gather(pd, 1, ii), torch.gather(pd, 1, jj)
    gi, gj = torch.gather(gd, 1, ii), torch.gather(gd, 1, jj)
    valid = torch.gather(mm, 1, ii) * torch.gather(mm, 1, jj)
    rel = (gj - gi) / torch.clamp(torch.minimum(gi, gj), min=1e-3)
    informative = (torch.abs(rel) > rel_tau) * valid
    spread = torch.clamp(pd.amax(1) - pd.amin(1), min=1e-3)[:, None]
    viol = F.relu(margin - torch.sign(rel) * (pi - pj) / spread)
    return (viol * informative).sum() / torch.clamp(informative.sum(), min=1.0)


def save_weights(path: str, model: DepthNet) -> None:
    """``model``'s weights as the shipped ``depthnet_synthetic.npz`` holds
    them (`depthnet.py:179`): flax keys under "params/", ``np.savez``'s
    bytes, written to a temporary file and moved into place (a killed run
    never leaves a truncated npz)."""
    savez_atomic(path, flax_conv_net_flat(model, "params/"))


def load_depthnet(path: Optional[str] = None, device="cuda") -> Optional[DepthNet]:
    """DepthNet with the shipped weights (``$VIDU4D_DEPTHNET_NPZ`` or
    ``vidu4d_tpu/weights/depthnet_synthetic.npz``) on ``device``; None
    when the file does not exist."""
    return load_net(DepthNet(), path or weights_path(WEIGHTS_ENV, WEIGHTS_FILE), device)
