"""Device timing with CUDA events and CUDA graphs, and the H100 roofline."""
from __future__ import annotations

import functools
from typing import Callable

import torch


def median_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream over
    ``reps`` runs, each between two CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
# sheet, dense): HBM bytes/s, and FLOP/s by the type the arithmetic runs in
# (bf16 and "tf32" on the tensor cores, f32 outside them).
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}


def roofline(flops: float, nbytes: float, dtype=torch.float32) -> dict:
    """The least time an H100 could take for work of ``flops`` operations in
    ``dtype`` that must move ``nbytes``: bound_ms, the larger of the bytes
    over the memory rate and the operations over the peak, and bound_by,
    which of the two ("bytes" or "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@functools.cache
def _capture_stream(device: int) -> torch.cuda.Stream:
    """One side stream per device for every capture: cuBLAS keeps a
    workspace for each stream it has run on, so a new stream per call
    would hold one more workspace each time."""
    return torch.cuda.Stream(device)


def graph_ms(fn: Callable[[], object], calls: int = 10, reps: int = 20,
             warmup: int = 3) -> float:
    """Median device milliseconds of one ``fn()``: ``calls`` calls captured
    in one CUDA graph, the graph replayed ``reps`` times between CUDA
    events. A replay launches no Python, so a short kernel is timed without
    the host time of its wrapper (which median_ms includes whenever the
    host, not the device, is the slower)."""
    stream = _capture_stream(torch.cuda.current_device())
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return sorted(times)[len(times) // 2]
