"""Device-busy milliseconds per traced train step (the union of the
device events over the traced steps, grid updates included)."""


def read(r):
    return r.device_ms_per_unit() if r.mode == "train" else None
