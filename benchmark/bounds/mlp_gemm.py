"""The least time of the f32 matrix products of a NeRF++ train step in a
traced run, forward and backward: the background MLP on every background
sample (the program's traced ``nerfpp.bg_samples`` counter), and the
appearance basis and MLP_Fea on each step's shaded samples
(``r.calls["mlp_gemm"]``: the configuration and the step's shaded count).

Each MLP is counted as ``work.mlp_work`` counts a fused MLP: forward, 2 FLOPs
a multiply-add of every layer; backward, the weights' gradient of every
layer and the input's gradient of every layer autograd asks it of (all but
the background's first, whose input is an embedding of the rays); bytes
of the MLP's inputs and outputs (the backward: the inputs, the outputs'
gradient and, where asked, the inputs' gradient) and of its weights (and
their gradient) once each, at the f32 peak (three TF32 passes,
``lib/work.py``)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from benchmark.lib import spans, work
from benchmark.reference import tensorf as ref
from benchmark.reference import tensorf_nerfpp as pref


def mlp_s(widths: Sequence[Tuple[int, int]], rows: int, n_in: int, n_out: int,
          first_dgrad: bool) -> float:
    """Least seconds of one MLP's forward and backward on ``rows`` rows:
    layers (in, out), ``n_in`` input and ``n_out`` output columns."""
    macs = sum(a * b for a, b in widths)
    dgrad = sum(a * b for i, (a, b) in enumerate(widths) if i > 0 or first_dgrad)
    weights = sum(a * b + b for a, b in widths)
    fwd = work.bound_s(2.0 * rows * macs, 4.0 * (rows * (n_in + n_out) + weights), "f32")
    bwd_cols = n_in + n_out + (n_in if first_dgrad else 0)
    bwd = work.bound_s(2.0 * rows * (macs + dgrad), 4.0 * (rows * bwd_cols + 2 * weights), "f32")
    return fwd + bwd


def bound_s(r) -> Optional[float]:
    steps = r.calls.get("mlp_gemm")
    bg_rows = spans.traced_counts().get("nerfpp.bg_samples", 0)
    if not steps or not bg_rows:
        return None
    spec: pref.NerfPPSpec = steps[0][0]
    fg, C = spec.fg, spec.fg.feature_c
    basis = [(sum(fg.app_comp), fg.app_dim)]
    fea = [(ref.mlp_in(fg), C), (C, C), (C, 3)]
    total = 0.0
    for _, shaded in steps:
        n = int(shaded)
        total += mlp_s(basis, n, basis[0][0], fg.app_dim, True)
        total += mlp_s(fea, n, ref.mlp_in(fg), 3, True)
    n_in = 4 * (1 + 2 * spec.bg_freq) + 3 * (1 + 2 * spec.bg_view_freq)  # points, view
    return total + mlp_s(pref.bg_widths(spec), bg_rows, n_in, 1 + 3, False)
