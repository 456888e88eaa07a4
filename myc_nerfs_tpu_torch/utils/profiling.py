"""Where a train step's and a render chunk's time goes on a CUDA device.

- ``device_profile(fn)``: one ``fn()`` under torch.profiler; the device
  activity (kernels, copies, memsets) summed by name, and its union over
  the window.
- ``render_chunk_split(trainer, rays_o, rays_d, bg)``: one render chunk
  (render/ngp_render.py::render_rays_ngp) stage by stage (march, encode,
  SH, MLPs, composite), each stage timed alone with CUDA events.
- ``wall_ms(fn)``: one ``fn()`` on the host clock without the profiler,
  the denominator of the device's busy share.

chip_smoke.py prints both for the Car config; PERF.md section 5 reads them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from .timing import graph_ms, median_ms


TOP = 12  # device events listed by name; the rest are summed as other_ms


def device_profile(fn: Callable[[], object]) -> Dict:
    """Run ``fn()`` once under torch.profiler (CPU and CUDA activity).
    Returns the host wall ms of the window (profiler on), the device ms
    (the union of the device events' intervals), the sum of the device
    events by name (ms, with their count) for the TOP largest, the rest's
    sum, and every event's sum by name ("by_name")."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": 1e3 * wall, "device_ms": busy / 1e3, "events": len(spans),
            "kernels": {k: v for k, v in ranked[:TOP]},
            "other_ms": sum(v[0] for _, v in ranked[TOP:]), "by_name": dict(ranked)}


def render_chunk_split(trainer, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       bg: torch.Tensor) -> Dict[str, float]:
    """Each stage of one render chunk, timed alone through the functions
    the render calls (median_ms: CUDA events around a call, host time
    included where the host is the slower), and the whole chunk;
    ``mlp_device`` is the MLP stage's device time alone (graph_ms)."""
    from ..render.ngp_render import composite_marched, march_rays_fused, render_marched

    model, rcfg, occ = trainer.model, trainer.rcfg, trainer.state.occ
    out: Dict[str, float] = {}
    with torch.no_grad():
        def march():
            return march_rays_fused(trainer.occ_cfg, rcfg, occ, rays_o, rays_d,
                                    n_samples=rcfg.n_samples)

        marched = march()
        pos = marched.positions.reshape(-1, 3)
        dirs = marched.dirs.reshape(-1, 3)
        inputs = model.net_inputs(pos, dirs)
        raw = model(pos, dirs).reshape(*marched.positions.shape[:2], 4)

        out["march"] = median_ms(march)
        out["encode"] = median_ms(lambda: model.encode(pos))
        out["sh"] = median_ms(lambda: model.encode_dirs(dirs))
        out["mlp"] = median_ms(lambda: model.net(*inputs))
        out["mlp_device"] = graph_ms(lambda: model.net(*inputs))
        out["composite"] = median_ms(lambda: composite_marched(raw, marched, bg,
                                                               rcfg.early_stop_eps))
        out["chunk"] = median_ms(lambda: render_marched(model, march(), bg,
                                                        rcfg.early_stop_eps))
    return out


def wall_ms(fn: Callable[[], object]) -> float:
    """Host milliseconds of one ``fn()`` after a warm-up call, from a
    synchronised start to a synchronised end (no profiler)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)
