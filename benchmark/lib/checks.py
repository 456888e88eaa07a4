"""The numbers a training cell's check compares, from the program's
readings of its first steps and the reference's (``loss``, ``grad`` and
``change``: per step, and per leaf in the trainer's leaf order)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def leaf_gap(program: Sequence[float], reference: Sequence[float],
             keep: Optional[Sequence[bool]] = None) -> float:
    """The worst leaf's gap between two per-leaf norms, over the larger of
    that leaf's reference norm and the median leaf's."""
    ref = np.asarray(reference, np.float64)
    med = float(np.median(ref))
    gaps = [abs(p - r) / max(r, med, 1e-30)
            for i, (p, r) in enumerate(zip(program, ref)) if keep is None or keep[i]]
    return float(max(gaps)) if gaps else 0.0


def kept(grad_norms: Sequence[float]):
    """Leaves whose reference gradient is not nought to rounding: at least a
    thousandth of the median leaf's."""
    med = float(np.median(grad_norms))
    return [g >= 1e-3 * med for g in grad_norms]


def train_gaps(program: dict, trace) -> Dict[str, float]:
    """``loss_gap``: the worst step's relative loss gap; ``grad_gap``: the
    worst leaf's gap of the first gradient's norm; ``change_gap``: the same
    for the change of the parameters over the steps, over the kept leaves."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], trace.losses))
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(program["grad"], trace.grad_norms),
            "change_gap": leaf_gap(program["change"], trace.change_norms,
                                   kept(trace.grad_norms))}


def first_ids(total: int, batch: int, n: int):
    """The first n batches of ids the trainers' seed-0 shufflers (RayBatcher,
    PermutationSampler) hand out: a permutation of ``total`` from numpy's
    default_rng(0), taken in order, a new one drawn when the next batch
    would overrun."""
    rng = np.random.default_rng(0)
    perm, ptr, out = rng.permutation(total), 0, []
    for _ in range(n):
        if ptr + batch > total:
            perm, ptr = rng.permutation(total), 0
        out.append(perm[ptr:ptr + batch])
        ptr += batch
    return out
