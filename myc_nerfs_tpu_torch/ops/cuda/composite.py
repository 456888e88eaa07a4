"""The NGP compositor kernels' wrapper (csrc/composite.cu).

``ngp_composite(raw, dt, t, valid, bg, eps)`` composites the field's raw
[N, K, 4] on marched samples into (rgb [N, 3], depth [N], opacity [N],
n_samples), n_samples the int64 device scalar valid.sum(): one launch of
``ngp_composite_fwd_kernel`` (and valid.sum()'s own) on CUDA tensors, or a
raise on anything the kernel does not take. Where autograd records (grad
mode on and raw, dt, t or bg requiring grad: training, and test-time pose
optimisation through the march's backward), the launch goes through an autograd.Function whose
backward is one launch of ``ngp_composite_bwd_kernel``: the gradients to
raw, dt and t that are wanted, and bg's, T_left * g_rgb, here.
render/ngp_render.py::composite_marched calls it on CUDA tensors and runs
``composite_marched_plain``, the kernels' oracle, on CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._build import F32, I32, I64, PTR, STREAM

SOURCE = _build.CSRC / "composite.cu"
# raw, dt and its strides, t and its, valid and its, bg and its, eps, N, K
_INPUTS = [PTR, PTR, I64, I64, PTR, I64, I64, PTR, I64, I64, PTR, I64, I64, F32, I64, I32]
LIB = _build.Library(SOURCE, {"ngp_composite_fwd": _INPUTS + [PTR] * 3 + [STREAM],
                              "ngp_composite_bwd": _INPUTS + [PTR] * 6 + [STREAM]})


def _inputs(raw, dt, t, valid, bg, eps: float) -> list:
    """The kernels' input arguments: raw as it is (contiguous), the others
    read through their strides broadcast to [N, K] (bg to [N, 3])."""
    N, K, _ = raw.shape
    dt, t, valid = dt.expand(N, K), t.expand(N, K), valid.expand(N, K)
    bg = bg.expand(N, 3)
    return [raw.data_ptr(), dt.data_ptr(), *dt.stride(), t.data_ptr(), *t.stride(),
            valid.data_ptr(), *valid.stride(), bg.data_ptr(), *bg.stride(), eps, N, K]


def _broadcasts(shape, to) -> bool:
    return len(shape) <= len(to) and all(a in (1, b) for a, b in zip(reversed(shape),
                                                                      reversed(to)))


def _check(raw, dt, t, valid, bg) -> None:
    """What the kernels take; anything else raises."""
    if raw.device.type != "cuda":
        raise ValueError(f"ngp_composite: unsupported device {raw.device}")
    if raw.dim() != 3 or raw.shape[2] != 4:
        raise ValueError(f"raw must be [N, K, 4], got {tuple(raw.shape)}")
    N, K, _ = raw.shape
    for name, x, dtype, shape in (("raw", raw, torch.float32, None),
                                  ("dt", dt, torch.float32, (N, K)),
                                  ("t", t, torch.float32, (N, K)),
                                  ("valid", valid, torch.bool, (N, K)),
                                  ("bg", bg, torch.float32, (N, 3))):
        if x.device != raw.device:
            raise ValueError(f"ngp_composite: {name} on {x.device}, raw on {raw.device}")
        if x.dtype != dtype:
            raise TypeError(f"ngp_composite kernel takes {dtype} {name}, got {x.dtype}")
        if shape is not None and not _broadcasts(x.shape, shape):
            raise ValueError(f"{name} must broadcast to {list(shape)}, got {tuple(x.shape)}")


def _forward(raw, dt, t, valid, bg, eps: float):
    N, K, _ = raw.shape
    dev = raw.device
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(N, dtype=torch.float32, device=dev)
    opacity = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        LIB.launch("ngp_composite_fwd", dev, *_inputs(raw, dt, t, valid, bg, eps),
                   rgb.data_ptr(), depth.data_ptr(), opacity.data_ptr(),
                   counter="launch.ngp_composite")
    return rgb, depth, opacity, valid.expand(N, K).sum()


class _CompositeFn(torch.autograd.Function):
    """The forward kernel with its backward kernel: the gradients to raw, dt
    and t, recomputed from raw, dt, t, valid and bg (nothing per sample
    saved), and to bg from the forward's opacity."""

    @staticmethod
    def forward(ctx, raw, dt, t, valid, bg, eps):
        ctx.set_materialize_grads(False)
        rgb, depth, opacity, n_samples = _forward(raw, dt, t, valid, bg, eps)
        ctx.mark_non_differentiable(n_samples)
        ctx.save_for_backward(raw, dt, t, valid, bg, opacity)
        ctx.eps = eps
        return rgb, depth, opacity, n_samples

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_depth, g_opacity, _g_n):
        raw, dt, t, valid, bg, opacity = ctx.saved_tensors
        need_raw, need_dt, need_t, _, need_bg = ctx.needs_input_grad[:5]
        N, K, _ = raw.shape

        def out(wanted: bool, *shape):
            return torch.empty(shape, dtype=torch.float32, device=raw.device) if wanted else None

        # t reaches the outputs through depth alone
        g_raw, g_dt, g_t = out(need_raw, N, K, 4), out(need_dt, N, K), out(
            need_t and g_depth is not None, N, K)
        grads = [None if g is None else g.contiguous() for g in (g_rgb, g_depth, g_opacity)]
        if N and any(x is not None for x in (g_raw, g_dt, g_t)):
            LIB.launch("ngp_composite_bwd", raw.device, *_inputs(raw, dt, t, valid, bg, ctx.eps),
                       *(None if g is None else g.data_ptr() for g in (*grads, g_raw, g_dt, g_t)),
                       counter="launch.ngp_composite_bwd")
        g_bg = None
        if need_bg and g_rgb is not None:
            g_bg = ((1.0 - opacity)[:, None] * g_rgb).sum_to_size(bg.shape)
        return (g_raw, None if g_dt is None else g_dt.sum_to_size(dt.shape),
                None if g_t is None else g_t.sum_to_size(t.shape), None, g_bg, None)


def ngp_composite(raw: torch.Tensor, dt: torch.Tensor, t: torch.Tensor,
                  valid: torch.Tensor, bg: torch.Tensor, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rgb [N, 3], depth [N], opacity [N], n_samples) of raw [N, K, 4] f32
    on CUDA tensors: dt, t [N, K] f32, valid [N, K] bool and bg [3] or
    [N, 3] f32, each broadcast to its shape (read through strides, not
    copied); raises on anything the kernels do not take. Differentiable in
    raw, dt, t and bg (the backward kernel) where autograd records."""
    _check(raw, dt, t, valid, bg)
    if not raw.is_contiguous() or raw.data_ptr() % 16:
        raw = raw.clone(memory_format=torch.contiguous_format)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (raw, dt, t, bg)):
        return _CompositeFn.apply(raw, dt, t, valid, bg, float(eps))
    return _forward(raw, dt, t, valid, bg, float(eps))
