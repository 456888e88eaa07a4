"""Fused bias-free MLP: the Hopper kernels' wrappers and their plain versions.

Counterpart of myc_nerfs_tpu/ops/pallas/fused_mlp.py. ``fused_mlp(x,
weights)`` computes y = Wn(...relu(W1 relu(W0 x))...) with f32
accumulation and a cast to x's dtype after every layer, and is
differentiable (a ``torch.autograd.Function``, the JAX custom VJP):

- on CUDA tensors the forward and the backward launch the hand-written
  kernels in ``csrc/fused_mlp.cu`` (built with nvcc on first use) or raise;
- on CPU tensors they run ``fused_mlp_reference`` and
  ``fused_mlp_backward_reference``, the plain versions.

The backward follows the Pallas ``_bwd_kernel``: it recomputes the
forward's post-activations (rounded to x's dtype), accumulates each dW in
f32 from the unrounded f32 gradient, and rounds the gradient to x's dtype
before each dgrad product. Weights use the JAX layout, [in, out] per layer.
The kernels take widths that are multiples of 16 up to 64 (both NGP MLPs),
at most 8 layers, in bf16 (tensor cores) or f32 (CUDA cores); the plain
versions take any widths. ``mlp_work`` gives a call's flops, bytes and its
H100 bound from the shapes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from ...utils.timing import roofline
from . import _build

SOURCE = _build.CSRC / "fused_mlp.cu"
MAX_LAYERS = 8
MAX_WIDTH = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def fused_mlp_reference(x: torch.Tensor,
                        weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch forward: the CPU path and the kernel's oracle. Sums in
    f32 (f64 for f64 inputs, so that gradcheck can run on it)."""
    acc = _acc_dtype(x)
    h = x
    n = len(weights)
    for i, w in enumerate(weights):
        h = h.to(acc) @ w.to(acc)
        if i < n - 1:
            h = torch.relu(h)
        h = h.to(x.dtype)
    return h


def fused_mlp_backward_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                                 g: torch.Tensor, need_dx: bool = True
                                 ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Plain PyTorch backward, step by step as the Pallas ``_bwd_kernel``:
    the CPU path and the backward kernel's oracle. Returns (dx in x's
    dtype, or None without ``need_dx``; [dW_i in W_i's dtype]).

    Not the autograd of fused_mlp_reference: in bf16 that would round the
    gradient at every layer boundary before dW, and the kernel does not."""
    acc = _acc_dtype(x)
    n = len(weights)
    post = [x]  # post-activation input of each layer, in x's dtype
    for w in weights[:-1]:
        post.append(torch.relu(post[-1].to(acc) @ w.to(acc)).to(x.dtype))
    g = g.to(x.dtype).to(acc)
    dws: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i in range(n - 1, -1, -1):
        dws[i] = (post[i].to(acc).T @ g).to(weights[i].dtype)
        if i == 0 and not need_dx:
            return None, dws
        g = g.to(x.dtype).to(acc) @ weights[i].to(acc).T
        if i > 0:
            g = g * (post[i].to(acc) > 0.0)
    return g.to(x.dtype), dws


def mlp_work(widths: Sequence[int], rows: int, dtype: torch.dtype,
             backward: bool = False) -> dict:
    """The work of fused_mlp (or, with ``backward``, of fused_mlp_backward)
    on ``rows`` rows, from the shapes alone: the function's flops, the
    bytes it must move (x, y or g, dx and the weights and dW, each read or
    written once) and its H100 bound (utils.timing.roofline)."""
    size = torch.empty((), dtype=dtype).element_size()
    macs = [a * b for a, b in zip(widths[:-1], widths[1:])]
    if backward:
        # recompute the hidden layers, dW of every layer, dgrad down to dx
        flops = 2 * rows * (sum(macs[:-1]) + 2 * sum(macs))
        nbytes = (rows * (2 * widths[0] + widths[-1]) + 2 * sum(macs)) * size
    else:
        flops = 2 * rows * sum(macs)
        nbytes = (rows * (widths[0] + widths[-1]) + sum(macs)) * size
    return roofline(flops, nbytes, dtype)


def build() -> Tuple[Path, float]:
    """Compile csrc/fused_mlp.cu (see _build.build). Returns (path,
    seconds spent compiling; 0.0 when it was already built)."""
    return _build.build(SOURCE)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.fused_mlp_plan.argtypes = [ints, i32, i32, i32, ints, ints]
    lib.fused_mlp_fwd.argtypes = [ptr, ptr, ptrs, ints, i32, i64, i32, i32, ptr]
    lib.fused_mlp_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptrs, ints,
                                  i32, i64, i32, ptr]
    for fn in (lib.fused_mlp_plan, lib.fused_mlp_fwd, lib.fused_mlp_bwd):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan(widths: Tuple[int, ...], code: int, backward: bool,
          device: int) -> Tuple[int, int]:
    """(CTAs of the persistent grid, rows a CTA takes per step) of one
    kernel for a layer chain on one device, worked out once: the C side's
    occupancy query and shared-memory limit stay out of every call."""
    lib = _library()
    ctas, rows = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.fused_mlp_plan((ctypes.c_int * len(widths))(*widths),
                                 len(widths) - 1, code, int(backward),
                                 ctypes.byref(ctas), ctypes.byref(rows))
    if err == -2:
        raise ValueError(f"fused_mlp {'backward ' if backward else ''}kernel: "
                         f"widths {list(widths)} need more shared memory than "
                         "a CTA can have")
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel plan failed (error {err})")
    return ctas.value, rows.value


def _ctas(widths: Sequence[int], x: torch.Tensor, backward: bool) -> int:
    ctas, rows = _plan(tuple(widths), _DTYPE_CODE[x.dtype], backward, x.device.index)
    return max(1, min(ctas, -(-x.shape[0] // rows)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernels move 16-byte
    vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_chain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [M, D_in], got shape {tuple(x.shape)}")
    if not weights:
        raise ValueError("fused_mlp needs at least one layer")
    d = x.shape[1]
    for i, w in enumerate(weights):
        if w.dim() != 2 or w.shape[0] != d:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not "
                             f"take a width-{d} input")
        d = w.shape[1]


def _kernel_widths(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> List[int]:
    """The checks both kernels share; returns the layer widths."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mlp kernel takes float32 or bfloat16, got {x.dtype}")
    if len(weights) > MAX_LAYERS:
        raise ValueError(f"fused_mlp kernel takes at most {MAX_LAYERS} layers")
    widths = [x.shape[1]] + [w.shape[1] for w in weights]
    if any(d % 16 or d > MAX_WIDTH for d in widths):
        raise ValueError(f"fused_mlp kernel takes widths that are multiples "
                         f"of 16 up to {MAX_WIDTH}, got {widths}")
    for w in weights:
        if w.device != x.device or w.dtype != x.dtype:
            raise ValueError("fused_mlp: weights must share x's device and dtype")
    return widths


def _c_args(weights: Sequence[torch.Tensor], widths: Sequence[int]):
    return ((ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights]),
            (ctypes.c_int * len(widths))(*widths))


def _forward(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_mlp_reference(x, weights)
    widths = _kernel_widths(x, weights)
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    y = torch.empty((x.shape[0], widths[-1]), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _library()
    ctas = _ctas(widths, x, backward=False)
    w_ptrs, c_widths = _c_args(weights, widths)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_mlp_fwd(x.data_ptr(), y.data_ptr(), w_ptrs, c_widths,
                                len(weights), x.shape[0], _DTYPE_CODE[x.dtype],
                                ctas, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed (error {err})")
    fused_mlp.launches += 1
    return y


def fused_mlp_backward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       g: torch.Tensor, need_dx: bool = True
                       ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """(dx, [dW_i]) of fused_mlp at x for the output gradient g [M, D_out].

    CPU tensors take fused_mlp_backward_reference. CUDA tensors launch the
    backward kernel (then a fixed-order sum of the CTAs' partial dW, so the
    result does not change from run to run); anything the kernel does not
    take raises, and so does a failed build or launch."""
    _check_chain(x, weights)
    if g.shape != (x.shape[0], weights[-1].shape[1]):
        raise ValueError(f"g has shape {tuple(g.shape)}, the output "
                         f"{(x.shape[0], weights[-1].shape[1])}")
    if x.device.type == "cpu":
        return fused_mlp_backward_reference(x, weights, g, need_dx)
    widths = _kernel_widths(x, weights)
    if g.device != x.device:
        raise ValueError("fused_mlp backward: g must share x's device")
    m = x.shape[0]
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    g = _aligned(g.to(x.dtype))
    sizes = [a * b for a, b in zip(widths[:-1], widths[1:])]
    dw = torch.empty(sum(sizes), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    if m == 0:
        dw.zero_()
    else:
        lib = _library()
        ctas = _ctas(widths, x, backward=True)
        w_ptrs, c_widths = _c_args(weights, widths)
        partial = torch.empty((ctas, sum(sizes)), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.fused_mlp_bwd(x.data_ptr(), g.data_ptr(),
                                    dx.data_ptr() if need_dx else None,
                                    dw.data_ptr(), partial.data_ptr(), ctas,
                                    w_ptrs, c_widths, len(weights), m,
                                    _DTYPE_CODE[x.dtype], stream)
        if err != 0:
            raise RuntimeError(f"fused_mlp backward kernel launch failed (error {err})")
        fused_mlp_backward.launches += 1
    dws = [t.view(a, b) for t, a, b in
           zip(torch.split(dw, sizes), widths[:-1], widths[1:])]
    return dx, dws


class _FusedMLP(torch.autograd.Function):
    """fused_mlp with its backward: saves x and the weights (not the
    activations; the backward recomputes them, as the Pallas kernel does)."""

    @staticmethod
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        return _forward(x, weights)

    @staticmethod
    def backward(ctx, gy):
        x, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dws = fused_mlp_backward(x, weights, gy, need_dx=need[0])
        return (dx if need[0] else None,
                *[dw if n else None for dw, n in zip(dws, need[1:])])


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """y = Wn(...relu(W1 relu(W0 x))...): x [M, D_in], weights[i] [D_i, D_i+1].

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    the backward one when autograd asks for a gradient; anything the kernels
    do not take raises, and so does a failed build or launch.
    """
    _check_chain(x, weights)
    return _FusedMLP.apply(x, *weights)


fused_mlp.launches = 0           # forward kernel launches
fused_mlp_backward.launches = 0  # backward kernel launches
