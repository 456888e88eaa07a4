"""The grid encode's least time over the device time of its kernels in
the traced train steps (%), forward and backward: positions in, features
out (gradient in) and the table elements the positions touch, each once."""


def read(r):
    return r.roofline_pct("grid_encode") if r.mode == "train" else None
