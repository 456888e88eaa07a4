"""Frequency positional encoding and BARF's coarse-to-fine mask
(counterpart of myc_nerfs_tpu/ops/encoding.py; barf nerf.py:423-430,
barf.py:344-357).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["positional_encoding", "barf_c2f_weights", "apply_c2f_mask"]


def positional_encoding(x: torch.Tensor, L: int) -> torch.Tensor:
    """[..., N] -> [..., 2*N*L]: sin and cos at frequencies 2^k pi, laid out
    [..., N, 2, L] (per input dim, the L sines then the L cosines) and
    flattened."""
    freq = (2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)) * math.pi
    spectrum = x[..., None] * freq                                   # [..., N, L]
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    return enc.reshape(x.shape[:-1] + (-1,))


def barf_c2f_weights(progress: torch.Tensor, L: int,
                     c2f: Tuple[float, float]) -> torch.Tensor:
    """Per-frequency weights in [0, 1], shape [L]: with alpha = (progress -
    start) / (end - start) * L, weight_k = (1 - cos(clip(alpha - k, 0, 1)
    pi)) / 2. ``progress`` is an f32 scalar tensor."""
    start, end = c2f
    alpha = (progress - start) / (end - start) * L
    k = torch.arange(L, dtype=torch.float32, device=progress.device)
    return (1.0 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2.0


def apply_c2f_mask(enc: torch.Tensor, weights: torch.Tensor, n_dims: int) -> torch.Tensor:
    """The weights [L] applied to a positional_encoding [..., 2*n_dims*L]
    (broadcast over the [n_dims, 2] axes of its layout)."""
    L = weights.shape[0]
    shaped = enc.reshape(enc.shape[:-1] + (n_dims, 2, L))
    return (shaped * weights).reshape(enc.shape)
