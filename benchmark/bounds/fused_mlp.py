"""The least time of the fused MLP calls of a traced run: per call
(``r.calls["mlp"]``: rows, widths, dtype, and whether autograd ran its
backward) the FLOPs of the rows handed to the kernel, and the bytes of
inputs, outputs and weights, each once."""
from __future__ import annotations

from typing import Optional

from benchmark.lib import work


def bound_s(r) -> Optional[float]:
    calls = r.calls.get("mlp")
    if not calls:
        return None
    total = 0.0
    for rows, widths, dtype, grad in calls:
        for backward in ((False, True) if grad else (False,)):
            f, n = work.mlp_work(widths, rows, dtype, backward)
            total += work.bound_s(f, n, dtype)
    return total
