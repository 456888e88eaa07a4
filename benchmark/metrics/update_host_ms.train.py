"""Host milliseconds of the parameter update per traced train step: the
program's ngp.update span (apply_param_update and the in-place copies) or
tensorf.update (both Adams and their adds), start to end."""
from benchmark.lib import spans

NAMES = ("ngp.update", "tensorf.update")


def read(r):
    if r.mode != "train":
        return None
    found = spans.program_spans(r.trace, NAMES)
    return 1e3 * sum(spans.seconds(e) for e in found) / r.units if found else None
