"""Idle device milliseconds per traced train step in which the host was in
the NeRF++ background (the program's nerfpp.* spans: its points, its MLP,
its composition): each idle gap goes to the innermost program span at its
middle."""
from benchmark.lib import spans


def read(r):
    if r.mode != "train":
        return None
    found = spans.program_spans(r.trace)
    if not any(e[0].startswith("nerfpp.") for e in found):
        return None
    idle = spans.idle_by_span(r.trace, found)
    return 1e3 * sum(v for n, v in idle.items() if n and n.startswith("nerfpp.")) / r.units
