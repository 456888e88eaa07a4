"""Bilinear / trilinear grid sampling with align_corners=True semantics
(counterpart of myc_nerfs_tpu/ops/grid_sample.py).

TensoRF's factor planes and lines (tensorf tensoRF.py:209-244) and its
alpha mask (tensorBase.py:39-59) are read with ``F.grid_sample(...,
mode='bilinear', align_corners=True, padding_mode='border')``: coordinates
in [-1, 1], x indexing the last axis (W), y the one before (H), z the depth
(D); out-of-range coordinates clamp to the border. ``line_sample`` is the
1-D lerp of a line [C, L], as grid_sample on [1, C, L, 1] at (0, t).

The ``*_cm`` forms return channels first, [C, M] for M flat coordinates:
the layout grid_sample writes, kept so the factor products and the basis
matmul read it without a transposed copy.

``cell_base_index`` keeps the JAX package's f32 arithmetic order, (c + 1) *
0.5 * (size - 1), then floor, then clip to [0, size - 2]: the alpha-mask
gate indexes a corner-dilated volume with it, and that decision must agree
with the JAX package's bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grid_sample_2d", "grid_sample_3d", "line_sample", "grid_sample_cm",
           "line_sample_cm", "cell_base_index"]


def grid_sample_cm(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [C, H, W] at coords [M, 2], or [C, D, H, W] at [M, 3] -> [C, M]."""
    lead = (1,) * (grid.dim() - 1)
    out = F.grid_sample(grid[None], coords.reshape(lead + (-1, coords.shape[-1])),
                        mode="bilinear", padding_mode="border", align_corners=True)
    return out.reshape(grid.shape[0], -1)


def line_sample_cm(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """line [C, L] at t [M] -> [C, M]."""
    return grid_sample_cm(line[:, :, None], torch.stack([torch.zeros_like(t), t], dim=-1))


def grid_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample grid [C, H, W] at coords [..., 2] ((x, y) in [-1, 1]) -> [..., C]."""
    out = grid_sample_cm(grid, coords.reshape(-1, 2)).t()
    return out.reshape(coords.shape[:-1] + (grid.shape[0],))


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample grid [C, D, H, W] at coords [..., 3] ((x, y, z) in [-1, 1]) -> [..., C]."""
    out = grid_sample_cm(grid, coords.reshape(-1, 3)).t()
    return out.reshape(coords.shape[:-1] + (grid.shape[0],))


def line_sample(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """1-D lerp of line [C, L] at t [...] in [-1, 1] -> [..., C]."""
    return line_sample_cm(line, t.reshape(-1)).t().reshape(t.shape + (line.shape[0],))


def cell_base_index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Start index (int64) of the trilinear cell a [-1, 1] coordinate falls in:
    the clamped floor of (coord + 1) * 0.5 * (size - 1), in f32."""
    if size == 1:
        return torch.zeros(coord.shape, dtype=torch.int64, device=coord.device)
    c = (coord + 1.0) * 0.5 * (size - 1)
    return torch.clamp(torch.floor(c).to(torch.int64), 0, size - 2)
