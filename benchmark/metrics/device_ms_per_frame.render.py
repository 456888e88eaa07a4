"""Device-busy milliseconds per traced 800x800 frame (the union of the
device events over the traced frames)."""


def read(r):
    return r.device_ms_per_unit() if r.mode == "render" else None
