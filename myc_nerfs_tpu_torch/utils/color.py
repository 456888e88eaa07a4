"""sRGB <-> linear colour (counterpart of myc_nerfs_tpu/utils/color.py;
jnerf dataset.py:37-51, the piecewise IEC 61966-2-1 curves)."""
from __future__ import annotations

import torch


def srgb_to_linear(img: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> linear."""
    return torch.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(img: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB, clipped to [0, 1] first."""
    img = torch.clamp(img, 0.0, 1.0)
    return torch.where(img <= 0.0031308, img * 12.92, 1.055 * img ** (1.0 / 2.4) - 0.055)
