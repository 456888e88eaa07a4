"""The grid encode's least time over the device time of its kernels in
the traced frames (%): positions in, features out and the table elements
the positions touch, each once."""


def read(r):
    return r.roofline_pct("grid_encode") if r.mode == "render" else None
