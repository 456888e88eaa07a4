"""The f32 products of the MLP family's field: their least time over the
device time of their cuBLAS kernels in the traced train steps (%), forward
and backward (benchmark/bounds/nerf_gemm.py)."""


def read(r):
    return r.roofline_pct("nerf_gemm") if r.mode == "train" else None
