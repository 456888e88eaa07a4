"""Gather and scatter-add rate probes: the Hopper kernels' wrappers and their
plain versions (counterparts of the Pallas probe kernels under
scripts/probe_r2*.py; see csrc/grid_probe.cu for which kernel each one
replaces).

- ``gather_rows(tab, idx)``: ``tab[idx]``, rows of a 2-D table.
- ``gather_lanes(tab, idx)``: ``take_along_dim(tab, idx, dim=1)``.
- ``scatter_add_rows(idx, val, n_rows)``: zeros [n_rows, W] with
  ``val[i]`` added into row ``idx[i]``.
- ``smem_scratch(n_bytes, device)``: the sum (2.0) of the first elements
  of the first and last 128-float rows of an n-byte scratch, written to 1.

CPU tensors (a CPU device for smem_scratch) run the plain versions; CUDA
ones launch the kernels of csrc/grid_probe.cu or raise. The kernels take
int32 indices; an index outside the table leaves its output zero in the
gathers and adds nothing in the scatter, where the plain versions raise.
``cli/probe_grid.py`` times them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from . import _build

SOURCE = _build.CSRC / "grid_probe.cu"
ROW_FLOATS = 128  # smem_scratch's row


def build() -> Tuple[Path, float]:
    """Compile csrc/grid_probe.cu (see _build.build). Returns (path,
    seconds spent compiling; 0.0 when it was already built)."""
    return _build.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_rows.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.gather_lanes.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.scatter_add_rows.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.smem_scratch.argtypes = [ptr, i64, ptr]
    for fn in (lib.gather_rows, lib.gather_lanes, lib.scatter_add_rows, lib.smem_scratch):
        fn.restype = ctypes.c_int
    lib.grid_probe_error_string.argtypes = [i32]
    lib.grid_probe_error_string.restype = ctypes.c_char_p
    return lib


def gather_rows_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab[idx.long()]


def gather_lanes_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(tab, idx.long(), dim=1)


def scatter_add_rows_reference(idx: torch.Tensor, val: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    out = torch.zeros((n_rows, val.shape[1]), dtype=val.dtype, device=val.device)
    return out.index_add_(0, idx.long(), val)


def _scratch_rows(n_bytes: int) -> int:
    if n_bytes < 4 * ROW_FLOATS or n_bytes % (4 * ROW_FLOATS):
        raise ValueError(f"scratch size must be a positive multiple of "
                         f"{4 * ROW_FLOATS} bytes, got {n_bytes}")
    return n_bytes // (4 * ROW_FLOATS)


def smem_scratch_reference(n_bytes: int, device="cuda") -> torch.Tensor:
    s = torch.zeros((_scratch_rows(n_bytes), ROW_FLOATS), device=device)
    s[0] = 1.0
    s[-1] = 1.0
    return (s[0, 0] + s[-1, 0]).reshape(1)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")


def _check_idx(name: str, idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes int32 indices, got {idx.dtype}")


def _run(name: str, device: torch.device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err}: "
                           f"{lib.grid_probe_error_string(err).decode()})")


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = tab[idx[i], :] for tab [T, W] and idx [N]. The kernel
    copies 16-byte vectors: a row must be a whole number of them."""
    if tab.device.type == "cpu":
        return gather_rows_reference(tab, idx)
    _check_cuda("gather_rows", tab, idx)
    _check_idx("gather_rows", idx)
    if tab.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows takes tab [T, W] and idx [N]")
    row_bytes = tab.shape[1] * tab.element_size()
    if row_bytes == 0 or row_bytes % 16 or tab.data_ptr() % 16:
        raise ValueError("gather_rows kernel takes 16-byte aligned rows of a "
                         "multiple of 16 bytes")
    out = torch.empty((idx.shape[0], tab.shape[1]), dtype=tab.dtype, device=tab.device)
    if idx.shape[0] == 0:
        return out
    _run("gather_rows", tab.device, tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
         idx.shape[0], row_bytes // 16, tab.shape[0])
    gather_rows.launches += 1
    return out


def gather_lanes(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, k] = tab[r, idx[r, k]] for f32 tab [R, C] and idx [R, K]."""
    if tab.device.type == "cpu":
        return gather_lanes_reference(tab, idx)
    _check_cuda("gather_lanes", tab, idx)
    _check_idx("gather_lanes", idx)
    if tab.dtype != torch.float32:
        raise TypeError(f"gather_lanes kernel takes a float32 table, got {tab.dtype}")
    if tab.dim() != 2 or idx.dim() != 2 or idx.shape[0] != tab.shape[0] or tab.shape[1] == 0:
        raise ValueError("gather_lanes takes tab [R, C] and idx [R, K]")
    out = torch.empty(idx.shape, dtype=tab.dtype, device=tab.device)
    if idx.numel() == 0:
        return out
    _run("gather_lanes", tab.device, tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
         idx.shape[0], idx.shape[1], tab.shape[1])
    gather_lanes.launches += 1
    return out


def scatter_add_rows(idx: torch.Tensor, val: torch.Tensor, n_rows: int) -> torch.Tensor:
    """zeros [n_rows, W] with val[i, :] added into row idx[i] (f32). The
    kernel adds 16-byte vectors with atomics, in no fixed order: W must be
    a multiple of 4."""
    if val.device.type == "cpu":
        return scatter_add_rows_reference(idx, val, n_rows)
    _check_cuda("scatter_add_rows", val, idx)
    _check_idx("scatter_add_rows", idx)
    if val.dtype != torch.float32:
        raise TypeError(f"scatter_add_rows kernel takes float32 values, got {val.dtype}")
    if val.dim() != 2 or idx.shape != (val.shape[0],) or n_rows < 1:
        raise ValueError("scatter_add_rows takes idx [N], val [N, W] and n_rows >= 1")
    if val.shape[1] == 0 or val.shape[1] % 4 or val.data_ptr() % 16:
        raise ValueError("scatter_add_rows kernel takes 16-byte aligned rows of a "
                         "multiple of 4 floats")
    out = torch.zeros((n_rows, val.shape[1]), dtype=val.dtype, device=val.device)
    if idx.shape[0] == 0:
        return out
    _run("scatter_add_rows", val.device, idx.data_ptr(), val.data_ptr(), out.data_ptr(),
         idx.shape[0], val.shape[1] // 4, n_rows)
    scatter_add_rows.launches += 1
    return out


def smem_scratch(n_bytes: int, device="cuda") -> torch.Tensor:
    """A one-element f32 tensor: 2.0 when an n-byte scratch was written.
    On a CUDA device the kernel takes n bytes of dynamic shared memory;
    a size the block may not have raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return smem_scratch_reference(n_bytes, device)
    if device.type != "cuda":
        raise ValueError(f"smem_scratch: unsupported device {device}")
    _scratch_rows(n_bytes)
    out = torch.empty(1, dtype=torch.float32, device=device)
    _run("smem_scratch", device, out.data_ptr(), n_bytes)
    smem_scratch.launches += 1
    return out


gather_rows.launches = 0
gather_lanes.launches = 0
scatter_add_rows.launches = 0
smem_scratch.launches = 0
