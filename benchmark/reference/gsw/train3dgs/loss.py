"""3DGS training losses: L1 + SSIM (port of gsworld_tpu/train3dgs/loss.py).

The Inria trainer's ``l1_loss + lambda_dssim * (1 - ssim)`` with
lambda_dssim = 0.2.  SSIM's 11x11 Gaussian window (sigma 1.5) runs as two
separable passes over edge-padded input, rows then columns, as the JAX
package does.  Each pass is eleven shifted adds in a fixed order, and so
is its backward: on the card a depthwise convolution may take a cuDNN
algorithm that adds in no fixed order, and the backward of a replicate
pad adds its edge rows with atomics, so the train step would not repeat
itself.  Images are (H, W, C).
"""

from __future__ import annotations

import torch

_WINDOW = 11
_SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_taps(dtype):
    """The normalised window's eleven weights, rounded to ``dtype``, as
    Python floats (made on the host: nothing to read from the device)."""
    x = torch.arange(_WINDOW, dtype=dtype) - (_WINDOW - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * _SIGMA ** 2))
    return (g / g.sum()).tolist()


def _shifted_sum(src, dim: int, n: int, taps):
    """sum_k taps[k] * src[k : k + n] along ``dim``, added in the order
    k = 0, 1, ..."""
    out = src.narrow(dim, 0, n) * taps[0]
    for k in range(1, len(taps)):
        out.add_(src.narrow(dim, k, n), alpha=taps[k])
    return out


class _EdgeBlur(torch.autograd.Function):
    """``apply(x, dim, taps)``: y[i] = sum_k taps[k] x[clamp(i + k - h, 0,
    n - 1)] along ``dim`` (n = x.shape[dim], h = len(taps) // 2), the
    edge-padded 1-D blur.  Forward and backward are shifted adds in a
    fixed order: the backward adds taps[k] * dy into the padded gradient
    at offset k, k = 0, 1, ..., then folds the h padded rows at each end
    onto the edge row, nearest first."""

    @staticmethod
    def forward(ctx, x, dim: int, taps):
        n = x.shape[dim]
        h = len(taps) // 2
        first, last = x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)
        xp = torch.cat([first] * h + [x] + [last] * h, dim)
        ctx.dim, ctx.taps = dim, taps
        return _shifted_sum(xp, dim, n, taps)

    @staticmethod
    def backward(ctx, dy):
        dim, taps = ctx.dim, ctx.taps
        n = dy.shape[dim]
        h = len(taps) // 2
        shape = list(dy.shape)
        shape[dim] = n + 2 * h
        dp = dy.new_zeros(shape)
        for k, t in enumerate(taps):
            dp.narrow(dim, k, n).add_(dy, alpha=t)
        dx = dp.narrow(dim, h, n).clone()
        for j in range(h):
            dx.narrow(dim, 0, 1).add_(dp.narrow(dim, h - 1 - j, 1))
            dx.narrow(dim, n - 1, 1).add_(dp.narrow(dim, n + h + j, 1))
        return dx, None, None


def _blur(x):
    """Separable 11x11 Gaussian blur with edge padding; x (C, H, W)."""
    taps = _gaussian_taps(x.dtype)
    return _EdgeBlur.apply(_EdgeBlur.apply(x, 1, taps), 2, taps)


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
