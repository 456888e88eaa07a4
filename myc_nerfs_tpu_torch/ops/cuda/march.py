"""The fused NGP march kernel's wrapper (csrc/march.cu).

``march_fused`` launches ``march_rays_fused_kernel`` on CUDA tensors, or
raises; render/ngp_render.py::march_rays_fused calls it for CUDA rays and
runs its plain version, ``march_rays_fused_plain``, the kernel's oracle, on
the CPU. Where autograd records (grad mode on and a ray or ``xi`` requiring
grad, as in test-time pose optimisation), the launch goes through an
autograd.Function whose backward is ``march_rays_fused_bwd_kernel``. The
kernel's scalars come in a ``MarchConstants``, each rounded to f32 as the
plain version's torch ops round it (ngp_render.py::march_constants).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build
from ._build import I64, PTR, STREAM

SOURCE = _build.CSRC / "march.cu"

_I, _F = ctypes.c_int, ctypes.c_float


class MarchConstants(ctypes.Structure):
    """The kernel's configuration, laid out as csrc/march.cu's March: its
    sizes and switches, and its scalars as f32 values."""

    _fields_ = [
        ("n_coarse", _I), ("n_samples", _I), ("grid_size", _I), ("n_cascades", _I),
        ("single_mip", _I),    # aabb_scale == 1: cascade 0 without mip math
        ("const_dt", _I),
        ("truncate", _I),      # trunc_eps > 0
        ("lo", _F), ("hi", _F),  # the cascade AABB
        ("near", _F),          # near_distance
        ("inv_coarse", _F),    # 1 / n_coarse
        ("inv_samples", _F),   # 1 / n_samples
        ("inv_extent", _F),    # 1 / (hi - lo)
        ("inv_min_cone", _F),  # 1 / min_cone_stepsize
        ("dt_const", _F),      # calc_dt's const_dt step
        ("dt_min", _F), ("dt_max", _F),  # calc_dt's clamp
        ("cone", _F),          # cone_angle_constant
        ("log_eps", _F),       # log(trunc_eps) (0 without truncation)
    ]


def _check_layout(functions, path: Path) -> None:
    """March and MarchConstants must hold the same bytes."""
    size = functions["march_constants_size"]()
    if size != ctypes.sizeof(MarchConstants):
        raise RuntimeError(f"{path}: March holds {size} bytes, "
                           f"MarchConstants {ctypes.sizeof(MarchConstants)}")


_TAIL = [ctypes.POINTER(MarchConstants), I64, STREAM]
LIB = _build.Library(SOURCE, {"march_rays_fused": [PTR] * 12 + _TAIL,
                              "march_rays_fused_bwd": [PTR] * 14 + _TAIL,
                              "march_constants_size": []}, on_load=_check_layout)


def _ptrs(*tensors):
    """The tensors' device pointers (None: null)."""
    return [t.data_ptr() if t is not None else None for t in tensors]


def _check(c: MarchConstants, density_grid: torch.Tensor, mean_density: torch.Tensor,
           rays_o: torch.Tensor, rays_d: torch.Tensor, xi: Optional[torch.Tensor]) -> None:
    """What the kernel takes; anything else raises."""
    if rays_o.device.type != "cuda":
        raise ValueError(f"march_fused: unsupported device {rays_o.device}")
    N = rays_o.shape[0]
    named = [("rays_o", rays_o), ("rays_d", rays_d), ("density_grid", density_grid),
             ("mean_density", mean_density)] + ([("xi", xi)] if xi is not None else [])
    for name, t in named:
        if t.device != rays_o.device:
            raise ValueError(f"march_fused: {name} on {t.device}, rays on {rays_o.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"march_fused kernel takes float32 {name}, got {t.dtype}")
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if tuple(t.shape) != (N, 3):
            raise ValueError(f"{name} must be [N, 3], got {tuple(t.shape)}")
    if xi is not None and xi.numel() != N:
        raise ValueError(f"xi must hold one jitter per ray, got {tuple(xi.shape)}")
    G = c.grid_size
    if tuple(density_grid.shape) != (c.n_cascades, G, G, G) or not density_grid.is_contiguous():
        raise ValueError(f"march_fused kernel takes a contiguous density grid of shape "
                         f"{(c.n_cascades, G, G, G)}, got {tuple(density_grid.shape)}")
    if mean_density.numel() != 1:
        raise ValueError("mean_density must be one value")


def _forward(c: MarchConstants, density_grid: torch.Tensor, mean_density: torch.Tensor,
             rays_o: torch.Tensor, rays_d: torch.Tensor, xi: Optional[torch.Tensor],
             save: bool) -> Tuple[Optional[torch.Tensor], ...]:
    """One launch on contiguous rays and xi [N] (or None): positions, t,
    valid, dt, dirs, and with ``save`` the backward's u [N, K] and n_occ
    [N] (else None, None)."""
    N, K = rays_o.shape[0], c.n_samples
    dev = rays_o.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = (empty(N, K, 3), empty(N, K), empty(N, K, dtype=torch.bool), empty(N),
            empty(N, 3), empty(N, K) if save else None, empty(N) if save else None)
    if N:
        LIB.launch("march_rays_fused", dev, *_ptrs(rays_o, rays_d, xi, density_grid,
                                                   mean_density, *outs), ctypes.byref(c), N,
                   counter="launch.march_rays_fused")
    return outs


class _MarchFn(torch.autograd.Function):
    """The kernel with its backward: the gradients of positions, t, dt and
    dirs to rays_o, rays_d and xi, every decision held fixed."""

    @staticmethod
    def forward(ctx, c, density_grid, mean_density, rays_o, rays_d, xi):
        pos, t, valid, dt, dirs, u, n_occ = _forward(c, density_grid, mean_density,
                                                     rays_o, rays_d, xi, save=True)
        ctx.mark_non_differentiable(valid)
        ctx.c = c
        ctx.save_for_backward(rays_o, rays_d, xi, t, dt, u, n_occ)
        return pos, t, valid, dt, dirs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_pos, g_t, _g_valid, g_dt, g_dirs):
        rays_o, rays_d, xi, t, dt, u, n_occ = ctx.saved_tensors
        N = rays_o.shape[0]
        g_o, g_d = torch.empty_like(rays_o), torch.empty_like(rays_d)
        g_xi = torch.empty_like(xi) if ctx.needs_input_grad[5] else None
        if N:
            LIB.launch("march_rays_fused_bwd", rays_o.device,
                       *_ptrs(rays_o, rays_d, xi, t, u, dt, n_occ, g_pos.contiguous(),
                              g_t.contiguous(), g_dt.contiguous(), g_dirs.contiguous(),
                              g_o, g_d, g_xi), ctypes.byref(ctx.c), N,
                       counter="launch.march_rays_fused_bwd")
        return None, None, None, g_o, g_d, g_xi


def march_fused(c: MarchConstants, density_grid: torch.Tensor, mean_density: torch.Tensor,
                rays_o: torch.Tensor, rays_d: torch.Tensor, xi: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """One launch of the fused march on CUDA tensors. Returns positions
    [N, K, 3] and dirs [N, 3] warped to [0, 1], t [N, K], valid [N, K] and
    dt [N]; raises on anything the kernel does not take. Differentiable in
    rays_o, rays_d and xi (the backward kernel), where autograd records."""
    _check(c, density_grid, mean_density, rays_o, rays_d, xi)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    if xi is not None:
        xi = xi.reshape(rays_o.shape[0]).contiguous()
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (rays_o, rays_d, xi)):
        return _MarchFn.apply(c, density_grid, mean_density, rays_o, rays_d, xi)
    return _forward(c, density_grid, mean_density, rays_o, rays_d, xi, save=False)[:5]
