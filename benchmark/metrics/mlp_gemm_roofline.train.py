"""The f32 MLP products' least time over the device time of their cuBLAS
kernels in the traced train steps (%), forward and backward: the NeRF++
background MLP on every background sample, the appearance basis and
MLP_Fea on the shaded samples (benchmark/bounds/mlp_gemm.py)."""


def read(r):
    return r.roofline_pct("mlp_gemm") if r.mode == "train" else None
