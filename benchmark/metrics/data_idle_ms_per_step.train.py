"""Idle device milliseconds per traced train step in which the host was
making the batch (the program's ngp.batch span) or copying it to the
device (ngp.h2d): each idle gap goes to the innermost program span at its
middle."""
from benchmark.lib import spans

NAMES = ("ngp.batch", "ngp.h2d")


def read(r):
    if r.mode != "train":
        return None
    found = spans.program_spans(r.trace)
    if not any(e[0] in NAMES for e in found):
        return None
    idle = spans.idle_by_span(r.trace, found)
    return 1e3 * sum(idle.get(n, 0.0) for n in NAMES) / r.units
