"""The least time of the f32 matrix products of the MLP family's field in a
traced train step, forward and backward: every layer of the field (the
configuration's widths, ``r.calls["nerf_gemm"]``: its reference spec) on
every sample the traced forwards evaluated (the program's traced
``nerf.samples`` counter), counted as ``bounds/mlp_gemm.py::mlp_s`` counts
an MLP.

The backward holds the weights' gradient of every layer and the input's
gradient of every layer but the first; the first layer's too on the steps
whose pose corrections apply (the program's traced ``nerf.pose_refined``
counter), where the points' gradient flows on to the poses. Inputs are the
points and the view directions, outputs the density and the rgb."""
from __future__ import annotations

from typing import Optional

from benchmark.bounds.mlp_gemm import mlp_s
from benchmark.lib import spans
from benchmark.reference import garf as gref


def bound_s(r) -> Optional[float]:
    specs = r.calls.get("nerf_gemm")
    counts = spans.traced_counts()
    samples = counts.get("nerf.samples", 0)
    if not specs or not samples or not r.units:
        return None
    widths = gref.layer_widths(specs[0])
    rows = samples // r.units
    refined = min(counts.get("nerf.pose_refined", 0), r.units)
    return (refined * mlp_s(widths, rows, 6, 4, True)
            + (r.units - refined) * mlp_s(widths, rows, 6, 4, False))
