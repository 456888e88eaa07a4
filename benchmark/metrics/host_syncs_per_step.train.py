"""Blocking CUDA runtime calls (a synchronise, or a copy made synchronous)
inside the program's own spans, per traced train step. The harness's own
synchronisations lie outside the program's spans and are not counted."""
from benchmark.lib import spans


def read(r):
    if r.mode != "train":
        return None
    found = spans.program_spans(r.trace)
    return len(spans.blocking_calls(r.trace, found)) / r.units if found else None
