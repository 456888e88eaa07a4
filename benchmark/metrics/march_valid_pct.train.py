"""Share of the sample slots the NGP march hands the field that are valid
(%), over the traced train steps: the program's counters ngp.march.valid
over ngp.march.slots."""
from benchmark.lib import spans


def read(r):
    if r.mode != "train":
        return None
    c = spans.traced_counts()
    slots = c.get("ngp.march.slots", 0)
    return 100.0 * c["ngp.march.valid"] / slots if slots > 0 else None
