"""The program's own spans and counters in a traced run.

myc_nerfs_tpu_torch names its phases with spans on torch.profiler's
timeline (``utils/profiling.py::span``, the names declared in its
``SPANS``) and counts quantities in a registry (``counts(traced=True)``:
what was counted while the profiler recorded). The reductions here find
the spans among a ``Trace``'s host events by those names:

- ``program_spans``: their intervals (name, start us, end us);
- ``innermost``: the innermost span running at each of a list of times;
- ``seconds`` and ``self_seconds``: a span's duration, and each name's
  time outside the spans nested in it;
- ``blocking_calls``: the CUDA runtime calls that block the host
  (``BLOCKING``) whose middle lies inside a span, with that span;
- ``idle_by_span``: the device's idle gaps by the innermost span at each
  gap's middle (None: outside every span).

A program without spans or counters leaves every reduction empty, and the
readers built on them return None.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Tuple

Event = Tuple[str, float, float]  # (name, start us, end us)

# CUDA runtime calls that wait for the device: a synchronise, or a copy the
# runtime makes synchronous (torch issues .item(), nonzero and pageable
# host-to-device copies as cudaMemcpyAsync followed by a stream synchronise)
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")


def _profiling():
    try:
        from myc_nerfs_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def declared() -> frozenset:
    """The span names the program declares (empty where it has none)."""
    return frozenset(getattr(_profiling(), "SPANS", ()))


def traced_counts() -> Dict[str, int]:
    """The program's counters over what was counted while a profiler
    recorded (empty where it has no registry)."""
    counts = getattr(_profiling(), "counts", None)
    return counts(traced=True) if counts is not None else {}


def program_spans(trace, names: Optional[Iterable[str]] = None) -> List[Event]:
    """The trace's host events named as the program's spans (``names``,
    default ``declared()``), by start; an outer span before the spans it
    holds."""
    names = declared() if names is None else frozenset(names)
    return sorted((e for e in trace.host if e[0] in names), key=lambda e: (e[1], -e[2]))


def seconds(event: Event) -> float:
    return (event[2] - event[1]) / 1e6


def innermost(spans: List[Event], times: List[float]) -> List[Optional[str]]:
    """For each of ``times`` (us, ascending) the name of the innermost span
    of ``spans`` (as ``program_spans`` orders them) running at it: spans
    nest, so the running one that started last; None where none runs."""
    out: List[Optional[str]] = []
    active: List[Tuple[float, float, str]] = []  # max-heap on start
    i = 0
    for at in times:
        while i < len(spans) and spans[i][1] <= at:
            name, a, b = spans[i]
            heapq.heappush(active, (-a, b, name))
            i += 1
        while active and active[0][1] <= at:
            heapq.heappop(active)
        out.append(active[0][2] if active else None)
    return out


def self_seconds(spans: List[Event]) -> Dict[str, float]:
    """Seconds of each span name outside the spans nested in it."""
    out: Dict[str, float] = {}
    stack: List[Event] = []
    for e in spans:
        while stack and stack[-1][2] <= e[1]:
            stack.pop()
        out[e[0]] = out.get(e[0], 0.0) + seconds(e)
        if stack:
            parent = stack[-1][0]
            out[parent] = out[parent] - seconds(e)
        stack.append(e)
    return out


def blocking_calls(trace, spans: List[Event]) -> List[Tuple[str, str]]:
    """(call, innermost span) of every blocking runtime call whose middle
    lies inside one of ``spans``."""
    calls = sorted((e for e in trace.host if e[0] in BLOCKING), key=lambda e: e[1] + e[2])
    where = innermost(spans, [0.5 * (a + b) for _, a, b in calls])
    return [(c[0], s) for c, s in zip(calls, where) if s is not None]


def idle_by_span(trace, spans: List[Event]) -> Dict[Optional[str], float]:
    """Idle device seconds between the device's busy intervals, by the
    innermost span at the middle of each gap (None: outside every span)."""
    busy = trace.busy_intervals()
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    out: Dict[Optional[str], float] = {}
    for (a, b), name in zip(gaps, innermost(spans, [0.5 * (a + b) for a, b in gaps])):
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out
