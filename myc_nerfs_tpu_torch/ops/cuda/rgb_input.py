"""The NGP rgb MLP's input kernel's wrapper (csrc/rgb_input.cu).

``rgb_input(h, dirs)`` builds x [M, 32] = [h | sh_encode(dirs * 2 - 1)] in
h's dtype, the rgb MLP's input: h [M, 16] is the density MLP's output,
dirs [M, 3] the sample directions warped to [0, 1]. CUDA tensors launch
``rgb_input_kernel`` (one launch, bit-equal to the plain version), or
raise; CPU tensors run ``rgb_input_plain``, the eager composition the
kernel replaces and its oracle. Where autograd records, the launch goes
through an autograd.Function: h's gradient is g[:, :16], as the
concatenation's backward gives it, and the directions' gradient, where
they require one (test-time pose optimisation), goes through the plain
sh_encode recomputed under autograd.
"""
from __future__ import annotations

import torch

from ..sh import sh_encode
from . import _build
from ._build import I32, I64, PTR, STREAM

SOURCE = _build.CSRC / "rgb_input.cu"
LIB = _build.Library(SOURCE, {"rgb_input": [PTR, PTR, I64, I64, PTR, I64, I32, STREAM]})
WIDTH = 16   # h's columns, and the SH bases' (degree 4)
DEGREE = 4


def rgb_input_plain(h: torch.Tensor, dirs: torch.Tensor, degree: int = DEGREE) -> torch.Tensor:
    """[h | sh_encode(dirs * 2 - 1, degree, 16) in h's dtype], by torch ops."""
    enc = sh_encode(dirs * 2.0 - 1.0, degree=degree, pad_to=WIDTH)
    return torch.cat([h, enc.to(h.dtype)], dim=-1)


def _check(h: torch.Tensor, dirs: torch.Tensor, degree: int) -> None:
    """What the kernel takes; anything else raises."""
    if h.device.type != "cuda":
        raise ValueError(f"rgb_input: unsupported device {h.device}")
    if dirs.device != h.device:
        raise ValueError(f"rgb_input: dirs on {dirs.device}, h on {h.device}")
    if degree != DEGREE:
        raise ValueError(f"rgb_input kernel encodes SH degree {DEGREE}, not {degree}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rgb_input kernel takes bfloat16 or float32 h, got {h.dtype}")
    if dirs.dtype != torch.float32:
        raise TypeError(f"rgb_input kernel takes float32 dirs, got {dirs.dtype}")
    M = h.shape[0]
    if h.dim() != 2 or h.shape[1] != WIDTH:
        raise ValueError(f"h must be [M, {WIDTH}], got {tuple(h.shape)}")
    if tuple(dirs.shape) != (M, 3):
        raise ValueError(f"dirs must be [{M}, 3], got {tuple(dirs.shape)}")


def _forward(h: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """One launch: x [M, 32] in h's dtype. dirs is read through its
    strides; h is copied first only where it is not contiguous and
    16-byte aligned."""
    if not h.is_contiguous() or h.data_ptr() % 16:
        h = h.clone(memory_format=torch.contiguous_format)
    M = h.shape[0]
    x = torch.empty((M, 2 * WIDTH), dtype=h.dtype, device=h.device)
    if M:
        LIB.launch("rgb_input", h.device, h.data_ptr(), dirs.data_ptr(), dirs.stride(0),
                   dirs.stride(1), x.data_ptr(), M, int(h.dtype == torch.bfloat16),
                   counter="launch.rgb_input")
    return x


class _RgbInputFn(torch.autograd.Function):
    """The kernel with the plain version's gradients: g[:, :16] to h, and
    to the directions autograd through the plain sh_encode."""

    @staticmethod
    def forward(ctx, h, dirs):
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(dirs)
        return _forward(h, dirs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g_h = g[:, :WIDTH] if ctx.needs_input_grad[0] else None
        g_dirs = None
        if ctx.needs_input_grad[1]:
            (dirs,) = ctx.saved_tensors
            with torch.enable_grad():
                d = dirs.detach().requires_grad_()
                enc = sh_encode(d * 2.0 - 1.0, degree=DEGREE, pad_to=WIDTH).to(g.dtype)
                (g_dirs,) = torch.autograd.grad(enc, d, g[:, WIDTH:])
        return g_h, g_dirs


def rgb_input(h: torch.Tensor, dirs: torch.Tensor, degree: int = DEGREE) -> torch.Tensor:
    """x [M, 32] = [h | sh_encode(dirs * 2 - 1, degree, 16)] in h's dtype:
    one kernel launch on CUDA tensors (degree 4; anything else the kernel
    does not take raises), rgb_input_plain on CPU tensors."""
    if h.device.type != "cuda":
        return rgb_input_plain(h, dirs, degree)
    _check(h, dirs, degree)
    if torch.is_grad_enabled() and (h.requires_grad or dirs.requires_grad):
        return _RgbInputFn.apply(h, dirs)
    return _forward(h, dirs)
