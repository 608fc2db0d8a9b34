"""Image reconstruction losses / metrics: L1, MSE, PSNR, SSIM, DSSIM + L1
(`vidu4d_tpu/ops/image_losses.py`).

SSIM: 11x11 Gaussian window with sigma 1.5, per-channel (depthwise)
convolution with SAME padding, C1/C2 for a dynamic range of 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR for images in [0, 1]."""
    err = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(err, min=1e-12)))


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of image pairs (..., C, H, W) in [0, 1]: one value per
    leading index (a scalar for a single (C, H, W) pair)."""
    lead, (c, h, w) = img1.shape[:-3], img1.shape[-3:]
    window = _gaussian_window(window_size, 1.5, img1.device).to(img1.dtype)
    kernel = window.expand(c, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x.reshape(-1, c, h, w), kernel, padding="same", groups=c)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3)).reshape(lead)


def dssim_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                  lambda_dssim: float = 0.2) -> torch.Tensor:
    """The standard 3DGS photometric loss on (C, H, W) images:
    (1 - lambda) L1 + lambda (1 - SSIM) (`image_losses.py:73`)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target))
