"""3DGS training losses: L1 + SSIM (port of gsworld_tpu/train3dgs/loss.py).

The Inria trainer's ``l1_loss + lambda_dssim * (1 - ssim)`` with
lambda_dssim = 0.2.  SSIM's 11x11 Gaussian window (sigma 1.5) runs as two
separable depthwise convolutions on edge-padded input, rows then columns,
as the JAX package does.  Images are (H, W, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WINDOW = 11
_SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_kernel(dtype, device):
    x = torch.arange(_WINDOW, dtype=dtype, device=device) - (_WINDOW - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * _SIGMA ** 2))
    return g / g.sum()


def _blur(x):
    """Separable 11x11 Gaussian blur with edge padding; x (C, H, W)."""
    c = x.shape[0]
    g = _gaussian_kernel(x.dtype, x.device)
    h = _WINDOW // 2
    x = F.conv2d(F.pad(x[None], (0, 0, h, h), mode="replicate"),
                 g.reshape(1, 1, _WINDOW, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(F.pad(x, (h, h, 0, 0), mode="replicate"),
                 g.reshape(1, 1, 1, _WINDOW).repeat(c, 1, 1, 1), groups=c)
    return x[0]


def ssim(img1, img2):
    """Mean SSIM over an (H, W, C) pair in [0, 1]."""
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)
    # the five blurred maps in one depthwise pass
    mu1, mu2, e11, e22, e12 = _blur(
        torch.cat([a, b, a * a, b * b, a * b])).chunk(5)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu12
    s = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return s.mean()


def l1_loss(img1, img2):
    return (img1 - img2).abs().mean()


def gs_loss(render, target, lambda_dssim: float = 0.2):
    """(1 - l) * L1 + l * (1 - SSIM)."""
    return ((1.0 - lambda_dssim) * l1_loss(render, target)
            + lambda_dssim * (1.0 - ssim(render, target)))


def psnr(img1, img2):
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))
