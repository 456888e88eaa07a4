"""Device timing with CUDA events."""
from __future__ import annotations

from typing import Callable

import torch


def median_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream over
    ``reps`` runs, each between two CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]
