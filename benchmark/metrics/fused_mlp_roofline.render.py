"""The MLPs' least time over the device time of their kernels in the
traced frames (%): FLOPs of the rows handed to the kernels, bytes of
inputs, outputs and weights, each once."""


def read(r):
    return r.roofline_pct("fused_mlp") if r.mode == "render" else None
