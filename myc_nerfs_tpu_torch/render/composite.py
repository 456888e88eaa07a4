"""Volume-rendering composition (counterpart of myc_nerfs_tpu/render/composite.py).

- NeRF quadrature composite (barf model/nerf.py:405-421)
- TensoRF raw2alpha cumprod transmittance (tensorf tensorBase.py:17-24)
- NGP CalcRgb per-sample compositing with a background blend (jnerf
  calc_rgb.py:35-158): a masked exclusive transmittance scan.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]],
                                  dim=-1), dim=-1)


def composite_nerf(ray: torch.Tensor, rgb_samples: torch.Tensor,
                   density_samples: torch.Tensor, depth_samples: torch.Tensor,
                   bg_color: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """NeRF quadrature compositing.

    ray [..., R, 3] (unnormalised), rgb [..., R, N, 3], density [..., R, N],
    depth [..., R, N, 1]. Returns (rgb [..., R, 3], depth [..., R, 1],
    opacity [..., R, 1], prob [..., R, N, 1]).
    """
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)
    intv = depth_samples[..., 1:, 0] - depth_samples[..., :-1, 0]
    intv = torch.cat([intv, torch.full_like(intv[..., :1], 1e10)], dim=-1)
    sigma_delta = density_samples * (intv * ray_length)
    alpha = 1.0 - torch.exp(-sigma_delta)
    T = torch.exp(-_exclusive_cumsum(sigma_delta))
    prob = (T * alpha)[..., None]
    depth = (depth_samples * prob).sum(-2)
    rgb = (rgb_samples * prob).sum(-2)
    opacity = prob.sum(-2)
    if bg_color is not None:
        rgb = rgb + bg_color * (1.0 - opacity)
    return rgb, depth, opacity, prob


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """alpha = 1-exp(-sigma*dist), exclusive cumprod transmittance.
    Returns (alpha, weights, bg_weight[..., -1:])."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    one_minus = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                          dim=-1)
    T = torch.cumprod(one_minus, dim=-1)
    return alpha, alpha * T[..., :-1], T[..., -1:]


def composite_weights(sigma: torch.Tensor, dt: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      early_stop_eps: float = 1e-4
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NGP per-sample weights with validity mask + early termination.

    sigma/dt/valid [..., N]. Invalid samples add no optical depth; samples
    whose incoming transmittance is below ``early_stop_eps`` get weight 0.
    Returns (weights [..., N], T_left [..., 1]).
    """
    sigma_delta = sigma * dt
    if valid is not None:
        sigma_delta = torch.where(valid, sigma_delta, 0.0)
    T = torch.exp(-_exclusive_cumsum(sigma_delta))
    alpha = 1.0 - torch.exp(-sigma_delta)
    weights = torch.where(T > early_stop_eps, T * alpha, 0.0)
    if valid is not None:
        weights = torch.where(valid, weights, 0.0)
    T_left = torch.clamp(1.0 - weights.sum(-1, keepdim=True), 0.0, 1.0)
    return weights, T_left


def composite_rgb(rgb_samples: torch.Tensor, weights: torch.Tensor,
                  T_left: torch.Tensor, bg_color: torch.Tensor) -> torch.Tensor:
    """Blend per-sample colours, and the leftover transmittance into the
    background. rgb [..., N, 3], weights [..., N], T_left [..., 1]."""
    return (rgb_samples * weights[..., None]).sum(-2) + T_left * bg_color
