"""Depth sampling: stratified bins and inverse-CDF importance sampling
(counterpart of myc_nerfs_tpu/render/sampling.py; barf nerf.py:286-317,
tensorf ray_utils.py:195+).

The random draws are arguments: the stratified jitter of ``sample_depth``
and the uniforms of ``sample_pdf`` (the JAX package draws them from keys).
``searchsorted`` runs with ``right=True``, as ``side="right"`` in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["sample_depth", "sample_depth_from_pdf", "sample_pdf"]


def sample_depth(rand: Optional[torch.Tensor], shape: Tuple[int, ...], n_samples: int,
                 depth_range: Tuple[float, float], param: str = "metric",
                 device=None) -> torch.Tensor:
    """Depth samples [*shape, n_samples, 1] over depth_range: bin i holds
    (i + rand) / n_samples of the range, ``rand`` [*shape, n_samples, 1]
    uniform in [0, 1) (stratified), or the bin midpoints where it is None.
    ``param='inverse'`` returns reciprocal depths (nerf.py:286-296)."""
    depth_min, depth_max = depth_range
    if rand is None:
        rand = torch.full(tuple(shape) + (n_samples, 1), 0.5, device=device)
    rand = rand + torch.arange(n_samples, dtype=torch.float32, device=rand.device)[:, None]
    depth = rand / n_samples * (depth_max - depth_min) + depth_min
    if param == "inverse":
        depth = 1.0 / (depth + 1e-8)
    return depth


def _searchsorted_right(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)


def sample_depth_from_pdf(pdf: torch.Tensor, n_fine: int,
                          depth_range: Tuple[float, float]) -> torch.Tensor:
    """Fine depths [..., n_fine, 1] by inverse-transform sampling of the
    per-bin pdf [..., N] over the N coarse bins of depth_range, at the
    deterministic midpoints (nerf.py:298-317). Differentiable in pdf."""
    depth_min, depth_max = depth_range
    N = pdf.shape[-1]
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)      # [..., N+1]
    grid = torch.linspace(0.0, 1.0, n_fine + 1, dtype=pdf.dtype, device=pdf.device)
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(cdf.shape[:-1] + (n_fine,))
    idx = _searchsorted_right(cdf.detach(), unif)
    depth_bin = torch.linspace(depth_min, depth_max, N + 1, dtype=pdf.dtype,
                               device=pdf.device)
    depth_bin = depth_bin.expand(cdf.shape)
    lo = torch.clamp(idx - 1, 0, N)
    hi = torch.clamp(idx, 0, N)
    depth_low = torch.gather(depth_bin, -1, lo)
    depth_high = torch.gather(depth_bin, -1, hi)
    cdf_low = torch.gather(cdf, -1, lo)
    cdf_high = torch.gather(cdf, -1, hi)
    t = (unif - cdf_low) / (cdf_high - cdf_low + 1e-8)
    return (depth_low + t * (depth_high - depth_low))[..., None]


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hierarchical sampling over explicit bin edges bins [..., M+1] with
    weights [..., M]: at the deterministic midpoints where ``u`` is None,
    else at the uniforms ``u`` [..., n_samples] (ray_utils.py:195+)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)      # [..., M+1]
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(cdf.shape[:-1] + (n_samples,))
    M1 = cdf.shape[-1]
    idx = _searchsorted_right(cdf.detach(), u)
    below = torch.clamp(idx - 1, 0, M1 - 1)
    above = torch.clamp(idx, 0, M1 - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins = bins.expand(cdf.shape)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = torch.where(cdf_g1 - cdf_g0 < 1e-5, 1.0, cdf_g1 - cdf_g0)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)
