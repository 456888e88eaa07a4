"""Image metrics (counterpart of myc_nerfs_tpu/utils/metrics.py).

img2mse/mse2psnr as jnerf losses/mse_loss.py:6-14.
"""
from __future__ import annotations

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse + 1e-12)


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mse2psnr(img2mse(x, y))
