"""Fused bias-free MLP: the Hopper kernel's wrapper and its plain version.

Counterpart of myc_nerfs_tpu/ops/pallas/fused_mlp.py. ``fused_mlp(x,
weights)`` computes y = Wn(...relu(W1 relu(W0 x))...) with f32
accumulation and a cast to x's dtype after every layer:

- on a CUDA tensor it launches the hand-written kernel in
  ``csrc/fused_mlp.cu`` (built with nvcc on first use) or raises;
- on a CPU tensor it runs ``fused_mlp_reference``, the plain version.

Weights use the JAX layout, [in, out] per layer. The kernel takes widths
that are multiples of 16 up to 64 (both NGP MLPs); the plain version takes
any widths. Forward only: the backward kernel arrives with training.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "fused_mlp.cu"
BUILD_DIR = _PKG / "csrc" / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_LAYERS = 8
MAX_WIDTH = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_mlp_reference(x: torch.Tensor,
                        weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle."""
    h = x
    n = len(weights)
    for i, w in enumerate(weights):
        h = h.float() @ w.float()
        if i < n - 1:
            h = torch.relu(h)
        h = h.to(x.dtype)
    return h


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build csrc/fused_mlp.cu")


def build() -> Tuple[Path, float]:
    """Compile csrc/fused_mlp.cu into csrc/build/ unless a library built
    from the same source and flags is already there. Returns (path,
    seconds spent compiling; 0.0 when it was already built)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfused_mlp_{tag}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds agree on one file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, time.perf_counter() - t0


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.fused_mlp_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.fused_mlp_fwd.restype = ctypes.c_int
    return lib


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


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """y = Wn(...relu(W1 relu(W0 x))...): x [M, D_in], weights[i] [D_i, D_i+1].

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    anything the kernel does not take raises, and so does a failed build
    or launch.
    """
    _check_chain(x, weights)
    if x.device.type == "cpu":
        return fused_mlp_reference(x, weights)
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
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(w.requires_grad for w in weights)):
        raise RuntimeError("fused_mlp kernel is forward-only; run it under "
                           "torch.no_grad() (the backward kernel is not ported)")
    x = x.contiguous()
    weights = [w.contiguous() for w in weights]
    y = torch.empty((x.shape[0], widths[-1]), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _library()
    w_ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    c_widths = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mlp_fwd(x.data_ptr(), y.data_ptr(), w_ptrs, c_widths,
                                len(weights), x.shape[0], _DTYPE_CODE[x.dtype],
                                stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed (error {err})")
    fused_mlp.launches += 1
    return y


fused_mlp.launches = 0
