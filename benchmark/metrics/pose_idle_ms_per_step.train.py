"""Idle device milliseconds per traced train step in which the host was in
the MLP family's pose path (the program's nerf.pose span: the refined
poses, the drawn pixels, the rays): each idle gap goes to the innermost
program span at its middle."""
from benchmark.lib import spans


def read(r):
    if r.mode != "train":
        return None
    found = spans.program_spans(r.trace)
    if not any(e[0] == "nerf.pose" for e in found):
        return None
    idle = spans.idle_by_span(r.trace, found)
    return 1e3 * idle.get("nerf.pose", 0.0) / r.units
