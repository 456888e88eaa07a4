"""Factor sampling's least time over the device time of its kernels in the
traced train steps (%), forward and backward: per plane-line pair the
coordinates in, the products out (their gradient in), and the factor
elements the gated (density) and shaded (appearance) samples touch, each
once (the backward reads and writes them)."""


def read(r):
    return r.roofline_pct("factor_sampling") if r.mode == "train" else None
