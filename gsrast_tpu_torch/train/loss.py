"""Training losses: L1 + D-SSIM, the standard 3DGS objective, as the
reference (`gsrast_tpu/train/loss.py`) defines them.

SSIM uses the 11x11 sigma-1.5 Gaussian window as a depthwise convolution
with zero "same" padding. On a CUDA device a float32 convolution goes
through cuDNN in TF32 unless told otherwise, which keeps about three
decimal digits; the filter turns TF32 off for its own forward and backward
convolutions only and restores the flags afterwards.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..camera import no_tf32


@functools.lru_cache()
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _conv(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise "same" correlation of (1, C, H, W) with an odd window."""
    c = x.shape[1]
    kernel = window.expand(c, 1, *window.shape)
    with no_tf32():
        return F.conv2d(x, kernel, padding=window.shape[-1] // 2, groups=c)


class _Filter(torch.autograd.Function):
    """The window filter with a backward that is the same filter: the
    adjoint of a zero-padded "same" correlation is the correlation with the
    flipped window, and the Gaussian window is symmetric. Writing it out
    keeps the backward convolution under the TF32 guard too, which autograd
    would run after the guard is gone."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.save_for_backward(window)
        return _conv(x, window)

    @staticmethod
    def backward(ctx, grad):
        (window,) = ctx.saved_tensors
        return _conv(grad.contiguous(), window), None


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter on (H, W, C) with zero "same" padding."""
    out = _Filter.apply(img.permute(2, 0, 1)[None].contiguous(), window)
    return out[0].permute(1, 2, 0)


def ssim(img0: torch.Tensor, img1: torch.Tensor, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair in [0, 1]."""
    window = torch.as_tensor(_gaussian_window(), device=img0.device)
    mu0 = _filter2d(img0, window)
    mu1 = _filter2d(img1, window)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = _filter2d(img0 * img0, window) - mu00
    sigma11 = _filter2d(img1 * img1, window) - mu11
    sigma01 = _filter2d(img0 * img1, window) - mu01
    num = (2.0 * mu01 + c1) * (2.0 * sigma01 + c2)
    den = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(num / den)


def l1(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img0 - img1))


def rgb_loss(pred: torch.Tensor, target: torch.Tensor,
             ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - w) L1 + w (1 - SSIM): the 3DGS training objective."""
    return (1.0 - ssim_weight) * l1(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
