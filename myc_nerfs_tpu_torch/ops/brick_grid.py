"""Brick-packed multiresolution grid encode, brick3 forward (counterpart of
myc_nerfs_tpu/ops/brick_grid.py).

The table layout is the JAX package's, so its checkpoints load as they are:
one tensor per level group, [rows, len(group) * F * 128], where a row holds
the 5^3 vertices of a 4^3-cell brick (lane v = ix*25 + iy*5 + iz, lanes
125..127 unused) for each member level, feature-major. Dense levels index
bricks row-major; hashed levels hash the brick coordinate with the
reference's primes, masked by the power-of-two row count. A group keys its
row by its finest member; a coarser member stores the window of its own
vertices that covers the key brick.

The JAX package reaches the 8 live vertices of a sample through TPU
workarounds: one-hot matmuls for small tables (ONEHOT_MAX_ROWS) and 5x128
selector matmuls that spread the per-axis tent weights over all 128 lanes.
Here each level gathers its 8 live vertices and weights them directly: the
same numbers with less work.

``paired_encode`` is the entry point: on the card it runs the kernels of
csrc/grid_encode.cu (ops/cuda/grid_encode.py). ``paired_encode_reference``
and ``paired_encode_backward_reference`` are their plain versions, the CPU
path and the kernels' oracles.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.ngp import HASH_PRIMES, HashGridConfig, _U32

BRICK_CELLS = 4          # cells per axis per brick
BRICK_VERTS = 5          # vertices per axis (4 cells)
ROW_VERTS = 128          # 5^3 = 125 padded to one lane group


@dataclasses.dataclass(frozen=True)
class BrickLevels:
    """Host-side static per-level geometry of the brick layout."""

    scales: Tuple[float, ...]
    resolutions: Tuple[int, ...]
    brick_dims: Tuple[Tuple[int, int, int], ...]
    dense: Tuple[bool, ...]
    n_bricks: Tuple[int, ...]
    bricks_per_level: int
    n_levels: int


def compute_brick_levels(cfg: HashGridConfig) -> BrickLevels:
    """Same scale/res derivation as models/ngp.compute_levels; brick
    budget = 2^log2_hashmap_size / 128 rows."""
    bricks_per_level = max(1, (1 << cfg.log2_hashmap_size) // ROW_VERTS)
    scales, resos, dims, dense, counts = [], [], [], [], []
    for lv in range(cfg.n_levels):
        scale = 2.0 ** (lv * np.log2(cfg.per_level_scale)) * cfg.base_resolution - 1.0
        res = int(np.ceil(scale)) + 1
        bx = (res + BRICK_CELLS - 1) // BRICK_CELLS
        is_dense = bx ** 3 <= bricks_per_level
        scales.append(float(scale))
        resos.append(res)
        dims.append((bx, bx, bx))
        dense.append(is_dense)
        counts.append(bx ** 3 if is_dense else bricks_per_level)
    return BrickLevels(scales=tuple(scales), resolutions=tuple(resos),
                       brick_dims=tuple(dims), dense=tuple(dense),
                       n_bricks=tuple(counts),
                       bricks_per_level=bricks_per_level,
                       n_levels=cfg.n_levels)


@dataclasses.dataclass(frozen=True)
class LevelGroups:
    """Levels sharing one table row, coarse -> fine; the last member is the
    key level whose brick grid indexes the row."""

    groups: Tuple[Tuple[int, ...], ...]


def compute_level_groups(levels: BrickLevels, min_ratio: float = 4.0 / 3.0,
                         group_size: int = 2) -> LevelGroups:
    """Group up to ``group_size`` consecutive hashed levels from the fine
    end; dense levels and any ratio-violating hashed level stay single."""
    hashed = [lv for lv in range(levels.n_levels) if not levels.dense[lv]]
    groups = [(lv,) for lv in range(levels.n_levels) if levels.dense[lv]]
    i = len(hashed) - 1
    while i >= 0:
        members = [hashed[i]]
        j = i - 1
        while (j >= 0 and len(members) < group_size
               and hashed[j] == members[-1] - 1
               and (levels.scales[members[-1]] / levels.scales[hashed[j]])
               >= min_ratio):
            members.append(hashed[j])
            j -= 1
        groups.append(tuple(reversed(members)))
        i = j
    groups.sort()
    return LevelGroups(groups=tuple(groups))


def init_paired_table(generator: torch.Generator, cfg: HashGridConfig,
                      levels: Optional[BrickLevels] = None,
                      groups: Optional[LevelGroups] = None,
                      dtype=torch.float32, device=None) -> List[torch.Tensor]:
    """One tensor per group: [rows, len(group) * F * 128], uniform(+-1e-4)
    (jnerf hash_encoder.py:22-23)."""
    levels = levels or compute_brick_levels(cfg)
    groups = groups or compute_level_groups(levels)
    out = []
    for members in groups.groups:
        rows = levels.n_bricks[members[-1]]
        width = len(members) * cfg.n_features * ROW_VERTS
        t = torch.empty((rows, width), dtype=dtype, device=device)
        out.append(t.uniform_(-1e-4, 1e-4, generator=generator))
    return out


def brick_coords(pos: torch.Tensor, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [N, 3] at one level scale -> (brick [N, 3] float integer-valued,
    u [N, 3] in [0, 4)): pos*scale + 0.5, floored to 4^3-cell bricks.
    (Python scalars round to f32 in the op, like JAX's weak-typed ones, and
    need no host-to-device copy.)"""
    p = pos * scale + 0.5
    brick = torch.floor(torch.floor(p) * (1.0 / BRICK_CELLS))
    return brick, p - brick * BRICK_CELLS


def hash_bricks(brick: torch.Tensor) -> torch.Tensor:
    """Unmasked uint32 prime-XOR hash of brick coords [..., 3], as int64
    values in [0, 2^32): uint32 wraparound emulated by masking."""
    b = brick.to(torch.int64) & _U32
    return (((b[..., 0] * HASH_PRIMES[0]) & _U32)
            ^ ((b[..., 1] * HASH_PRIMES[1]) & _U32)
            ^ ((b[..., 2] * HASH_PRIMES[2]) & _U32))


def hat_tents(u: torch.Tensor, i0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tent weights max(0, 1 - |u - i|) at vertices i = i0 and i0 + 1
    (u, i0 float [..., 3]). Same arithmetic as the JAX package's 5-vertex
    tents, evaluated only where they can be nonzero."""
    lo = torch.clamp_min(1.0 - torch.abs(u - i0), 0.0)
    hi = torch.clamp_min(1.0 - torch.abs(u - (i0 + 1.0)), 0.0)
    return lo, hi


def _brick_ids(levels: BrickLevels, lv: int, brick: torch.Tensor) -> torch.Tensor:
    """Row index (int64) for float brick coords [N, 3] (integer-valued).

    Dense: row-major, computed in f32 with a clip instead of a mod, as the
    JAX package does. Hashed: the prime-XOR hash masked by the power-of-two
    row count."""
    if levels.dense[lv]:
        bx, by, bz = levels.brick_dims[lv]
        b = [torch.clamp(brick[:, a], 0.0, float(d - 1))
             for a, d in enumerate((bx, by, bz))]
        idx = b[0] + b[1] * bx + b[2] * (bx * by)
        return idx.to(torch.int32).to(torch.int64)
    n = levels.n_bricks[lv]
    if n & (n - 1):
        raise ValueError("hashed brick count must be a power of two")
    return hash_bricks(brick) & (n - 1)


def _level_taps(pos: torch.Tensor, cfg: HashGridConfig, levels: BrickLevels,
                groups: LevelGroups, wdtype):
    """For each level, (group g, level lv, base [N, 8], w [N, 8]): the flat
    index into group g's table of each of the 8 live vertices of the
    sample's cell (feature 0; feature f is + f * 128) and its trilinear
    weight in ``wdtype``. The forward gathers these, the backward adds
    into them; the kernels in csrc/grid_encode.cu compute the same."""
    F = cfg.n_features
    c = torch.arange(8, device=pos.device)
    # corner c = 4*dx + 2*dy + dz: weight (wx*wy)*wz, lane +25dx +5dy +dz
    corner_lane = (c >> 2) * (BRICK_VERTS * BRICK_VERTS) + ((c >> 1) & 1) * BRICK_VERTS + (c & 1)
    for g, members in enumerate(groups.groups):
        width = len(members) * F * ROW_VERTS
        key_lv = members[-1]
        brick, u_key = brick_coords(pos, levels.scales[key_lv])
        row = _brick_ids(levels, key_lv, brick)
        for j, lv in enumerate(members):
            if lv == key_lv:
                u = u_key
            else:
                # a coarser member's window base depends on the key brick
                # only, in the JAX package's operation order
                inv_r = 1.0 / (levels.scales[key_lv] / levels.scales[lv])
                base_c = torch.floor((BRICK_CELLS * brick - 0.5) * inv_r + 0.5)
                u = (pos * levels.scales[lv] + 0.5) - base_c
            i0 = torch.clamp(torch.floor(u), 0.0, BRICK_VERTS - 2.0)
            lo, hi = hat_tents(u, i0)
            lo, hi = lo.to(wdtype), hi.to(wdtype)
            wx = torch.stack([lo[:, 0], hi[:, 0]], -1)[:, :, None, None]
            wy = torch.stack([lo[:, 1], hi[:, 1]], -1)[:, None, :, None]
            wz = torch.stack([lo[:, 2], hi[:, 2]], -1)[:, None, None, :]
            w = (wx * wy * wz).reshape(-1, 8)
            i0 = i0.to(torch.int64)
            lane0 = i0[:, 0] * (BRICK_VERTS * BRICK_VERTS) + i0[:, 1] * BRICK_VERTS + i0[:, 2]
            base = (row * width + j * F * ROW_VERTS + lane0)[:, None] + corner_lane
            yield g, lv, base, w


def paired_encode_reference(tables: List[torch.Tensor], positions: torch.Tensor,
                            cfg: HashGridConfig, levels: Optional[BrickLevels] = None,
                            groups: Optional[LevelGroups] = None,
                            compute_dtype=None) -> torch.Tensor:
    """Encode positions [..., 3] in [0, 1] -> [..., n_levels * F] with torch
    ops: the plain version of the brick_encode kernel, differentiable in the
    tables through autograd, not in the positions (the JAX package's
    stop_pos_grad, as the kernel's autograd function).

    ``compute_dtype=torch.bfloat16`` interpolates in bf16 while the tables
    stay f32, like the JAX package's bf16 path: table values, weights and
    each product are rounded to bf16, the 8 products are summed in f32 (in
    f64 for f64 tables).

    The 8 products are summed in corner order, ((p0 + p1) + p2) + ... + p7,
    as the kernel sums them: an f32 sum of products that span more than 24
    bits is rounded, so another order (torch's ``sum`` leaves its own
    unstated) can move the bf16 output by one ulp.
    """
    levels = levels or compute_brick_levels(cfg)
    groups = groups or compute_level_groups(levels)
    F = cfg.n_features
    shape = positions.shape[:-1]
    pos = positions.detach().reshape(-1, 3)
    wdtype = compute_dtype or tables[0].dtype
    acc = torch.promote_types(wdtype, torch.float32)  # f64 for gradcheck
    per_level: List[Optional[torch.Tensor]] = [None] * levels.n_levels
    feature = ROW_VERTS * torch.arange(F, device=pos.device)[:, None]
    for g, lv, base, w in _level_taps(pos, cfg, levels, groups, wdtype):
        flat = tables[g].reshape(-1)
        prod = (flat[base[:, None, :] + feature].to(wdtype) * w[:, None, :]).to(acc)
        total = prod[..., 0]
        for c in range(1, 8):
            total = total + prod[..., c]
        per_level[lv] = total.to(wdtype)
    out = torch.cat(per_level, dim=-1)
    return out.reshape(shape + (cfg.out_dim,))


def paired_encode_backward_reference(tables: List[torch.Tensor], positions: torch.Tensor,
                                     grad_out: torch.Tensor, cfg: HashGridConfig,
                                     levels: Optional[BrickLevels] = None,
                                     groups: Optional[LevelGroups] = None,
                                     compute_dtype=None) -> List[torch.Tensor]:
    """The tables' gradient for the output gradient ``grad_out`` [...,
    n_levels * F]: the plain version of the brick_encode_bwd kernel. Each
    (sample, level, corner, feature) contributes w * g, computed in the
    compute dtype as the autograd of paired_encode_reference computes it
    (rounded to bf16 in bf16), and is added in f32 (f64 for f64 tables)
    with index_add_. Only the tables' shapes, dtypes and device are read."""
    levels = levels or compute_brick_levels(cfg)
    groups = groups or compute_level_groups(levels)
    F = cfg.n_features
    pos = positions.reshape(-1, 3)
    wdtype = compute_dtype or tables[0].dtype
    g_out = grad_out.reshape(-1, levels.n_levels, F).to(wdtype)
    grads = [torch.zeros(t.shape, dtype=torch.promote_types(t.dtype, torch.float32),
                         device=t.device) for t in tables]
    for g, lv, base, w in _level_taps(pos, cfg, levels, groups, wdtype):
        flat = grads[g].view(-1)
        for f in range(F):
            contrib = g_out[:, lv, f, None] * w
            flat.index_add_(0, (base + f * ROW_VERTS).reshape(-1),
                            contrib.reshape(-1).to(flat.dtype))
    return grads


def paired_encode(tables: List[torch.Tensor], positions: torch.Tensor,
                  cfg: HashGridConfig, levels: Optional[BrickLevels] = None,
                  groups: Optional[LevelGroups] = None,
                  compute_dtype=None) -> torch.Tensor:
    """Encode positions [..., 3] in [0, 1] -> [..., n_levels * F],
    differentiable in the tables (not in the positions, as the JAX
    package's stop_pos_grad).

    CUDA tensors launch the brick_encode kernels (forward, and backward
    when autograd asks for the tables' gradient) or raise; CPU tensors run
    paired_encode_reference and paired_encode_backward_reference. See
    ops/cuda/grid_encode.py.
    """
    from .cuda import grid_encode  # imports this module

    levels = levels or compute_brick_levels(cfg)
    groups = groups or compute_level_groups(levels)
    return grid_encode.paired_encode(tables, positions, cfg, levels, groups,
                                     compute_dtype)
