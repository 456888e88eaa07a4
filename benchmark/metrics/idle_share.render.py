"""Share of the traced frames' wall time in which no operation ran on the
device (%): 1 - busy / wall, busy the union of the device events."""


def read(r):
    return r.idle_pct() if r.mode == "render" else None
