"""Blocking CUDA runtime calls (a synchronise, or a copy made synchronous)
inside the program's own spans, per traced frame."""
from benchmark.lib import spans


def read(r):
    if r.mode != "render":
        return None
    found = spans.program_spans(r.trace)
    return len(spans.blocking_calls(r.trace, found)) / r.units if found else None
