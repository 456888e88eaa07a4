"""The least time of the brick3 encode calls of a traced NGP run: per call
(``r.calls["encode"]``: positions, and whether autograd ran its backward)
the positions in, the features out (the backward: their gradient in), and
the table elements the positions touch, each once (the backward reads and
writes them)."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.lib import work
from benchmark.reference import ngp as ref


def touched(pos: torch.Tensor, spec: ref.NGPSpec, b: ref.Bricks) -> int:
    """Distinct table elements of a call's positions, group by group."""
    per_group: Dict[int, List[torch.Tensor]] = {}
    for a in range(0, pos.shape[0], 1 << 18):
        for g, _, base, _ in ref.level_taps(pos[a:a + (1 << 18)], spec, b):
            per_group.setdefault(g, []).append(torch.unique(base.reshape(-1)))
    return sum(torch.unique(torch.cat(v)).numel() for v in per_group.values()) * spec.n_features


def bound_s(r) -> Optional[float]:
    calls = r.calls.get("encode")
    if not calls:
        return None
    spec = r.spec
    b = ref.bricks(spec)
    total = 0.0
    for pos, grad in calls:
        n = touched(pos, spec, b)
        for backward in ((False, True) if grad else (False,)):
            f, nbytes = work.encode_work(pos.shape[0], spec.n_levels, spec.n_features, n,
                                         r.dtype, backward)
            total += work.bound_s(f, nbytes, "f32")
    return total
