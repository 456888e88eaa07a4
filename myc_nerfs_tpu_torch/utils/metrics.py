"""Image metrics (counterpart of myc_nerfs_tpu/utils/metrics.py).

img2mse/mse2psnr as jnerf losses/mse_loss.py:6-14; ssim as tensorf
utils.py:73-120 (rgb_ssim: a separable 11-tap gaussian, sigma 1.5, 'valid'
convolution).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse + 1e-12)


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mse2psnr(img2mse(x, y))


def _gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of an [H, W, C] image pair."""
    kern = _gaussian_kernel(filter_size, filter_sigma, img0.device).to(img0.dtype)
    C = img0.shape[-1]

    def filt(img):
        # the gaussian over H, then over W, per channel
        x = img.permute(2, 0, 1)[None]
        x = F.conv2d(x, kern.view(1, 1, -1, 1).expand(C, 1, -1, 1).contiguous(), groups=C)
        x = F.conv2d(x, kern.view(1, 1, 1, -1).expand(C, 1, 1, -1).contiguous(), groups=C)
        return x[0].permute(1, 2, 0)

    mu0 = filt(img0)
    mu1 = filt(img1)
    s00 = filt(img0 * img0) - mu0 ** 2
    s11 = filt(img1 * img1) - mu1 ** 2
    s01 = filt(img0 * img1) - mu0 * mu1
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
        (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))
    return ssim_map.mean()
