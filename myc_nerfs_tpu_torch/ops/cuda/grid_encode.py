"""Brick3 grid encode: the Hopper kernels' wrappers and the autograd.Function.

``paired_encode`` (reached through ops/brick_grid.py::paired_encode and
``NGPModel.encode``) runs one ``torch.autograd.Function``:

- on CUDA tensors its forward launches ``brick_encode`` and its backward
  ``brick_encode_backward``, the kernels of ``csrc/grid_encode.cu`` (built
  with nvcc on first use), or raises;
- on CPU tensors they run ``paired_encode_reference`` and
  ``paired_encode_backward_reference`` (ops/brick_grid.py), the plain
  versions and the kernels' oracles.

The forward saves only the positions (and references to the tables, for
their shapes); the backward recomputes each sample's rows and weights. No
gradient flows to the positions, as with the JAX package's stop_pos_grad.
The backward's reductions (warp sums, then f32 atomic adds) add in no
fixed order, so its result may differ from run to run in the last bits.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...utils.timing import roofline
from .. import brick_grid as bg
from . import _build

SOURCE = _build.CSRC / "grid_encode.cu"
FEATURES = (1, 2, 4, 8)
MAX_LEVELS = 32
MAX_GROUPS = 32
# Kernel against plain version, as a fraction of the plain output's (or each
# table gradient's) scale: f32 forward 1e-6, bf16 forward 2^-7 (two bf16
# ulps; both sum the same rounded products in the same corner order, so
# they agree bit for bit wherever they pick the same cell); the backward
# 1e-5 (the same contributions, summed by warp shuffles and f32 atomic adds
# in no fixed order).
FWD_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
BWD_TOL = 1e-5


def build() -> Tuple[Path, float]:
    """Compile csrc/grid_encode.cu (see _build.build). Returns (path,
    seconds spent compiling; 0.0 when it was already built)."""
    return _build.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints, floats = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    for fn in (lib.brick_encode_fwd, lib.brick_encode_bwd):
        fn.argtypes = [ptr, ptr, ptrs, i32, ints, floats, i32, i32, i64, i32, ptr]
        fn.restype = ctypes.c_int
    lib.grid_encode_error_string.argtypes = [i32]
    lib.grid_encode_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _level_args(cfg: bg.HashGridConfig, levels: bg.BrickLevels,
                groups: bg.LevelGroups):
    """The kernels' per-level constants as ctypes arrays, built once per
    geometry: ints (group, is_key, dense, bx, by, bz, rows mask, width,
    member offset) and f32 floats (key scale, scale, inv_r). The floats are
    the plain version's Python doubles rounded to f32 once, as torch rounds
    a Python scalar in an f32 op."""
    F = cfg.n_features
    ints = [None] * levels.n_levels
    floats = [None] * levels.n_levels
    for g, members in enumerate(groups.groups):
        key = members[-1]
        n = levels.n_bricks[key]
        if not levels.dense[key] and n & (n - 1):
            raise ValueError("hashed brick count must be a power of two")
        width = len(members) * F * bg.ROW_VERTS
        for j, lv in enumerate(members):
            ints[lv] = (g, int(lv == key), int(levels.dense[key]),
                        *levels.brick_dims[key],
                        0 if levels.dense[key] else n - 1, width, j * F * bg.ROW_VERTS)
            inv_r = 1.0 / (levels.scales[key] / levels.scales[lv])
            floats[lv] = (levels.scales[key], levels.scales[lv], inv_r)
    flat_i = [v for lv in ints for v in lv]
    flat_f = np.asarray(floats, np.float32).reshape(-1).tolist()  # f32-rounded
    return ((ctypes.c_int * len(flat_i))(*flat_i),
            (ctypes.c_float * len(flat_f))(*flat_f))


def _bf16_flag(compute_dtype) -> int:
    if compute_dtype in (None, torch.float32):
        return 0
    if compute_dtype == torch.bfloat16:
        return 1
    raise TypeError(f"brick_encode kernel computes in float32 or bfloat16, "
                    f"not {compute_dtype}")


def _check(tables: Sequence[torch.Tensor], pos: torch.Tensor, cfg: bg.HashGridConfig,
           levels: bg.BrickLevels, groups: bg.LevelGroups) -> None:
    """What the kernels take; anything else raises."""
    if pos.device.type != "cuda":
        raise ValueError(f"brick_encode: unsupported device {pos.device}")
    if pos.dtype != torch.float32:
        raise TypeError(f"brick_encode kernel takes float32 positions, got {pos.dtype}")
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be [N, 3], got {tuple(pos.shape)}")
    if not pos.is_contiguous():
        raise ValueError("brick_encode kernel takes contiguous positions")
    if cfg.n_features not in FEATURES:
        raise ValueError(f"brick_encode kernel takes n_features in {FEATURES}, "
                         f"got {cfg.n_features}")
    if levels.n_levels > MAX_LEVELS or len(groups.groups) > MAX_GROUPS:
        raise ValueError(f"brick_encode kernel takes at most {MAX_LEVELS} levels "
                         f"in {MAX_GROUPS} groups")
    if pos.shape[0] * levels.n_levels >= 2 ** 31:
        raise ValueError("brick_encode kernel takes fewer than 2^31 "
                         "(sample, level) pairs")
    if len(tables) != len(groups.groups):
        raise ValueError(f"{len(tables)} tables for {len(groups.groups)} groups")
    for members, t in zip(groups.groups, tables):
        shape = (levels.n_bricks[members[-1]],
                 len(members) * cfg.n_features * bg.ROW_VERTS)
        if t.device != pos.device:
            raise ValueError(f"brick_encode: a table on {t.device}, positions "
                             f"on {pos.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"brick_encode kernel takes float32 tables, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"brick_encode kernel takes contiguous tables of "
                             f"shape {shape}, got {tuple(t.shape)}")


def _launch(name: str, tables_or_grads: Sequence[torch.Tensor], pos: torch.Tensor,
            io: torch.Tensor, cfg, levels, groups, bf16: int) -> None:
    lib = _library()
    ilv, flv = _level_args(cfg, levels, groups)
    ptrs = (ctypes.c_void_p * len(tables_or_grads))(
        *[t.data_ptr() for t in tables_or_grads])
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = getattr(lib, name)(pos.data_ptr(), io.data_ptr(), ptrs,
                                 len(tables_or_grads), ilv, flv, levels.n_levels,
                                 cfg.n_features, pos.shape[0], bf16, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err}: "
                           f"{lib.grid_encode_error_string(err).decode()})")


def brick_encode(tables: Sequence[torch.Tensor], positions: torch.Tensor,
                 cfg: bg.HashGridConfig, levels: bg.BrickLevels,
                 groups: bg.LevelGroups, compute_dtype=None) -> torch.Tensor:
    """positions [N, 3] -> features [N, n_levels * F] in the compute dtype
    (the tables' without one). CPU tensors take paired_encode_reference;
    CUDA tensors launch the forward kernel or raise."""
    if positions.device.type == "cpu":
        return bg.paired_encode_reference(list(tables), positions, cfg, levels,
                                          groups, compute_dtype)
    _check(tables, positions, cfg, levels, groups)
    bf16 = _bf16_flag(compute_dtype)
    out = torch.empty((positions.shape[0], cfg.out_dim),
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=positions.device)
    if positions.shape[0] == 0:
        return out
    _launch("brick_encode_fwd", tables, positions, out, cfg, levels, groups, bf16)
    brick_encode.launches += 1
    return out


def brick_encode_backward(tables: Sequence[torch.Tensor], positions: torch.Tensor,
                          grad_out: torch.Tensor, cfg: bg.HashGridConfig,
                          levels: bg.BrickLevels, groups: bg.LevelGroups,
                          compute_dtype=None) -> List[torch.Tensor]:
    """The tables' gradients (f32, shaped as the tables) for the output
    gradient grad_out [N, n_levels * F]. CPU tensors take
    paired_encode_backward_reference; CUDA tensors launch the backward
    kernel (f32 atomic adds into zeroed gradients) or raise. Only the tables'
    shapes and device are read."""
    if positions.device.type == "cpu":
        return bg.paired_encode_backward_reference(list(tables), positions, grad_out,
                                                   cfg, levels, groups, compute_dtype)
    _check(tables, positions, cfg, levels, groups)
    bf16 = _bf16_flag(compute_dtype)
    if grad_out.shape != (positions.shape[0], cfg.out_dim):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}, the output "
                         f"{(positions.shape[0], cfg.out_dim)}")
    if grad_out.device != positions.device:
        raise ValueError("brick_encode backward: grad_out must share the "
                         "positions' device")
    g = grad_out.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    grads = [torch.zeros_like(t, dtype=torch.float32) for t in tables]
    if positions.shape[0] == 0:
        return grads
    _launch("brick_encode_bwd", grads, positions, g, cfg, levels, groups, bf16)
    brick_encode_backward.launches += 1
    return grads


def encode_work(tables: Sequence[torch.Tensor], positions: torch.Tensor,
                cfg: bg.HashGridConfig, levels: bg.BrickLevels, groups: bg.LevelGroups,
                compute_dtype=None, backward: bool = False) -> dict:
    """The work of brick_encode (or, with ``backward``, of
    brick_encode_backward) on these positions, from this run's data: the
    function's flops (per sample, level and corner, its weight and F
    multiply-adds) and the bytes it must move, each once: the positions, the
    features (or their gradient), and the table elements these positions
    touch (forward) or every element of the f32 table gradients, which the
    backward returns whole. With its H100 bound (utils.timing.roofline)."""
    n, F, L = positions.shape[0], cfg.n_features, levels.n_levels
    io_size = 2 if _bf16_flag(compute_dtype) else 4
    flops = n * L * 8 * (2 * F + 2)
    nbytes = n * 3 * 4 + n * L * F * io_size
    if backward:
        nbytes += sum(t.numel() for t in tables) * 4
    else:
        bases: dict = {}
        for g, _, base, _ in bg._level_taps(positions, cfg, levels, groups, torch.float32):
            bases.setdefault(g, []).append(base.reshape(-1))
        touched = sum(torch.unique(torch.cat(b)).numel() for b in bases.values()) * F
        nbytes += touched * tables[0].element_size()
    return roofline(flops, nbytes, torch.float32)


class _PairedEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, levels, groups, compute_dtype, positions, *tables):
        ctx.geometry = (cfg, levels, groups, compute_dtype)
        ctx.save_for_backward(positions, *tables)
        return brick_encode(tables, positions, cfg, levels, groups, compute_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        positions, *tables = ctx.saved_tensors
        grads = brick_encode_backward(tables, positions, grad_out, *ctx.geometry)
        need = ctx.needs_input_grad[5:]
        return (None,) * 5 + tuple(g if n else None for g, n in zip(grads, need))


def paired_encode(tables: Sequence[torch.Tensor], positions: torch.Tensor,
                  cfg: bg.HashGridConfig, levels: bg.BrickLevels,
                  groups: bg.LevelGroups, compute_dtype=None) -> torch.Tensor:
    """positions [..., 3] -> [..., n_levels * F] through _PairedEncode:
    differentiable in the tables, not in the positions."""
    shape = positions.shape[:-1]
    pos = positions.detach().reshape(-1, 3).contiguous()
    out = _PairedEncode.apply(cfg, levels, groups, compute_dtype, pos, *tables)
    return out.reshape(shape + (cfg.out_dim,))


brick_encode.launches = 0           # forward kernel launches
brick_encode_backward.launches = 0  # backward kernel launches
