"""The yardstick's arithmetic: published H100 peaks, the least time of a
piece of work, and the work of the kernels the per-layer metrics read.

A frozen copy of the port's own arithmetic at the time the benchmark was
written (utils/timing.py's roofline and peaks, ops/cuda/fused_mlp.py's
mlp_work, ops/cuda/grid_encode.py's encode_work), so that a later change
to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
BYTES_PER_S = 3.35e12
FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# f32-accurate products on the tensor cores take three TF32 passes: the
# repository's f32 peak since its wide f32 kernels.
F32_PEAK = FLOPS["tf32"] / 3.0


def peak_flops(dtype: str) -> float:
    """The peak a model's FLOPs are held against: bf16 989 TFLOP/s, f32
    495/3 TFLOP/s."""
    return FLOPS["bf16"] if dtype == "bf16" else F32_PEAK


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds an H100 could take: the larger of the bytes over
    the memory rate and the operations over the peak of ``dtype`` (f32:
    three TF32 passes)."""
    if dtype == "f32":
        return max(nbytes / BYTES_PER_S, 3.0 * flops / FLOPS["tf32"])
    return max(nbytes / BYTES_PER_S, flops / FLOPS[dtype])


def mlp_flops(widths: Sequence[int], rows: int) -> float:
    """Forward multiply-adds of a bias-free MLP, as FLOPs."""
    return 2.0 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_work(widths: Sequence[int], rows: int, dtype: str, backward: bool = False):
    """(flops, bytes) of one fused MLP call on ``rows`` rows: the forward's
    products, or the backward's recompute of the hidden layers, dW and the
    dgrad; bytes of x, the output (or g, dx), and the weights (and dW),
    each once."""
    size = 2 if dtype == "bf16" else 4
    macs = [a * b for a, b in zip(widths[:-1], widths[1:])]
    if backward:
        flops = 2.0 * rows * (sum(macs[:-1]) + 2 * sum(macs))
        nbytes = (rows * (2 * widths[0] + widths[-1]) + 2 * sum(macs)) * size
    else:
        flops = 2.0 * rows * sum(macs)
        nbytes = (rows * (widths[0] + widths[-1]) + sum(macs)) * size
    return flops, float(nbytes)


def encode_work(rows: int, n_levels: int, n_features: int, touched: int, dtype: str,
                backward: bool = False):
    """(flops, bytes) of one brick3 encode call on ``rows`` positions that
    read ``touched`` distinct f32 table elements: per position, level and
    corner a weight and F multiply-adds; the positions in, the features out
    (the backward: their gradient in), and the touched table elements read
    (the backward: their f32 gradient read and written)."""
    io = 2 if dtype == "bf16" else 4
    flops = float(rows * n_levels * 8 * (2 * n_features + 2))
    nbytes = rows * 3 * 4 + rows * n_levels * n_features * io
    nbytes += touched * 4 * (2 if backward else 1)
    return flops, float(nbytes)


def factor_work(samples: int, n_comp: int, plane_hw: Sequence[int], line_len: int,
                touched_plane: int, touched_line: int, backward: bool = False):
    """(flops, bytes) of sampling one VM factor pair (a plane [C, H, W]
    bilinearly and a line [C, L] linearly) at ``samples`` points: four and
    two products per channel; the coordinates in, the [C, samples] outputs
    (the backward: their gradient in), and the touched factor elements read
    (the backward: read and written)."""
    flops = float(samples * n_comp * (4 * 2 + 2 * 2))
    nbytes = samples * 3 * 4 + 2 * samples * n_comp * 4
    nbytes += (touched_plane + touched_line) * 4 * (2 if backward else 1)
    return flops, float(nbytes)
