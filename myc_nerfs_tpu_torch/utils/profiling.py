"""Where a train step's and a render chunk's time goes on a CUDA device.

- ``span(name)``: a named host span on torch.profiler's own timeline
  (function scope, as aten ops: no device-side annotation), entered only
  while a profiler records; otherwise one shared null context. ``SPANS``
  declares every name the package uses, each with what it covers.
- ``count(name, n)``: the counter registry (``COUNTERS``). Host ints always
  add to the totals (kernel launches: ``launch.<kernel>``); while a
  profiler records, ``n`` (a host int or a device scalar, kept by
  reference and summed when read) also adds to the traced totals.
  ``counts(traced)`` reads them, ``reset()`` zeroes both.
- ``trace(dir)``: a torch.profiler window written as a Chrome trace, the
  operator's way to see the spans in Perfetto or chrome://tracing.
- ``device_profile(fn)``: one ``fn()`` under torch.profiler; the device
  activity (kernels, copies, memsets) summed by name, and its union over
  the window.
- ``wall_ms(fn)``: one ``fn()`` on the host clock without the profiler,
  the denominator of the device's busy share.
- ``Throughput``: items per second between two host reads of a probe
  tensor; ``checkify_nan(fn)``: fn with a finite check of its floating
  outputs that raises (each check is a host sync: off the main path).

chip_smoke.py prints device_profile and wall_ms for the Car config; the
benchmark's per-layer metrics read the spans and the traced counters.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import torch

# -- spans and counters --------------------------------------------------------

SPANS: Dict[str, str] = {
    "ngp.grid_update": "one occupancy-grid update (render/occupancy.py)",
    "ngp.batch": "one block's ray batches on the host: RayBatcher, rays, pixels, "
                 "backgrounds, the stacks (cli/run_net.train_loop)",
    "ngp.h2d": "the block's host-to-device copies of rays, targets, backgrounds",
    "ngp.step": "one NGP train step (NGPTrainer._step)",
    "ngp.march": "the march: march_rays_fused, or march_rays with compact_marched",
    "ngp.field": "the field on the marched samples: encode, SH, both MLPs",
    "ngp.composite": "composite_marched",
    "ngp.loss": "the Huber loss and its mean",
    "ngp.backward": "autograd.grad of the loss",
    "ngp.update": "apply_param_update (clip, fp16 emulation, Adam, EMA), the in-place copies",
    "ngp.adapt_batch": "the batch adaptation's host read of the measured samples",
    "ngp.frame": "one whole-image render (NGPTrainer.render_image)",
    "ngp.chunk": "one render chunk's render_rays_ngp",
    "tensorf.batch": "one step's ray ids, permutation upload, draws and ray gathers",
    "tensorf.step": "one TensoRF train step (TensoRFTrainer.train_step)",
    "tensorf.sample": "sample_ray, dists, the alpha-mask gate, normalize_coord; in "
                      "nerfpp_forward the foreground's samples from near to the sphere's "
                      "exit, their jitter, dists, the AABB clip, the gate, normalize_coord",
    "tensorf.density": "masked_density and its nonzero (nerfpp_forward's foreground too)",
    "tensorf.shade": "raw2alpha, the weight threshold's nonzero, app features, "
                     "shade, scatter_rows (nerfpp_forward's foreground too)",
    "tensorf.composite": "composite_maps; in nerfpp_forward the foreground's rgb and "
                         "depth sums",
    "tensorf.regularizers": "ortho, L1, TV and a family's extra loss",
    "tensorf.backward": "autograd.grad of the loss",
    "tensorf.update": "both Adams and their in-place adds",
    "tensorf.events": "the stage events: alpha mask, shrink, upsample, ray refilter",
    "nerfpp.bg_points": "NeRF++'s background samples: inverse depths and their jitter, "
                        "depth2pts_outside (sphere intersection, Rodrigues rotation), both "
                        "embeddings, the flips",
    "nerfpp.bg_mlp": "the background MLP (BgMLPNet) on every background sample",
    "nerfpp.bg_composite": "background alpha, transmittance and maps, the foreground's "
                           "leftover transmittance bg_lambda, its > 0.1 gate, the fg/bg sum",
    "nerf.step": "one MLP-family (NeRF, BARF, GARF) train step (nerf_trainer.make_train_step)",
    "nerf.pose": "the step's poses and rays: compose_refined_pose (se3_to_SE3 of the "
                 "corrections, the gate), the drawn pixels' gather, get_center_and_ray",
    "nerf.field": "the samples' points and view directions, the MLP over them "
                  "(render/mlp_renderer.py)",
    "nerf.composite": "composite_nerf: quadrature weights, rgb, depth and opacity",
    "nerf.backward": "autograd.grad of the loss",
    "nerf.update": "both Adams (the MLP's, the pose corrections') and their adds",
}

COUNTERS: Dict[str, str] = {
    "ngp.march.slots": "sample slots the march hands the field (rays x samples per ray)",
    "ngp.march.valid": "valid samples among them (the compositor's n_samples, on the device)",
    "nerfpp.bg_samples": "NeRF++ background samples evaluated (rays x bg_samples per forward)",
    "nerf.samples": "MLP-family field samples evaluated (rays x samples per forward)",
    "nerf.pose_refined": "MLP-family pose compositions whose corrections apply (the gate "
                         "open, on the device): one per train step",
    "launch.fused_mlp": "narrow fused-MLP forward kernel launches",
    "launch.fused_mlp_bwd": "narrow fused-MLP backward kernel launches",
    "launch.fused_mlp_wide": "wide fused-MLP forward kernel launches",
    "launch.fused_mlp_wide_bwd": "wide fused-MLP backward launches (chain, dW, sum)",
    "launch.brick_encode": "brick3 encode forward kernel launches",
    "launch.brick_encode_bwd": "brick3 encode backward kernel launches",
    "launch.march_rays_fused": "fused NGP march kernel launches",
    "launch.march_rays_fused_bwd": "fused NGP march backward kernel launches",
    "launch.rgb_input": "NGP rgb-MLP input kernel launches ([h | SH(dirs)])",
    "launch.ngp_composite": "NGP compositor kernel launches",
    "launch.ngp_composite_bwd": "NGP compositor backward kernel launches",
    "launch.gather_rows": "grid probe gather_rows launches",
    "launch.gather_lanes": "grid probe gather_lanes launches",
    "launch.scatter_add_rows": "grid probe scatter_add_rows launches",
    "launch.smem_scratch": "grid probe smem_scratch launches",
}

_recording = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()

_totals: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
_traced: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
_traced_device: Dict[str, List[torch.Tensor]] = {k: [] for k in COUNTERS}


def span(name: str):
    """A span named ``name`` (declared in SPANS) while a torch profiler
    records, else the shared null context."""
    assert name in SPANS, f"undeclared span {name!r}"
    return _record(name) if _recording() else _NULL


def count(name: str, n) -> None:
    """Add ``n`` (a host int, or a device scalar tensor) to counter
    ``name`` (declared in COUNTERS): a host int to the totals, and while a
    profiler records, ``n`` to the traced totals. A tensor costs no kernel
    and no sync: it is kept and summed when read."""
    assert name in COUNTERS, f"undeclared counter {name!r}"
    tensor = isinstance(n, torch.Tensor)
    if not tensor:
        _totals[name] += n
    if _recording():
        if tensor:
            _traced_device[name].append(n)
        else:
            _traced[name] += n


def counts(traced: bool = False) -> Dict[str, int]:
    """Every declared counter's total since the last reset: of the host
    ints, or with ``traced`` of everything counted while a profiler
    recorded (a read of the kept device scalars: one sync)."""
    if not traced:
        return dict(_totals)
    out = dict(_traced)
    for name, ts in _traced_device.items():
        if ts:
            out[name] += int(torch.stack([t.reshape(()) for t in ts]).sum())
    return out


def reset() -> None:
    """Zero every counter, traced or not."""
    for name in COUNTERS:
        _totals[name] = _traced[name] = 0
        _traced_device[name].clear()


# -- device time ----------------------------------------------------------------

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


def wall_ms(fn: Callable[[], object]) -> float:
    """Host milliseconds of one ``fn()`` after a warm-up call, from a
    synchronised start to a synchronised end (no profiler)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where available),
    written to ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _host_read(probe) -> None:
    """Wait for ``probe`` by reading one element of it on the host."""
    float(torch.as_tensor(probe).reshape(-1)[0])


class Throughput:
    """Items per second between ``start(probe)`` and ``stop(probe)``; each
    reads an element of its probe, so the device work queued before it is
    done."""

    def __init__(self):
        self.items = 0
        self.t0 = None

    def start(self, probe=None) -> None:
        if probe is not None:
            _host_read(probe)
        self.t0 = time.perf_counter()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += n

    def stop(self, probe) -> float:
        _host_read(probe)
        dt = time.perf_counter() - self.t0
        return self.items / dt if dt > 0 else 0.0


def _floating(out):
    if torch.is_tensor(out):
        return [out] if out.is_floating_point() else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _floating(o)]
    return []


def checkify_nan(fn: Callable) -> Callable:
    """fn whose floating tensor outputs (nested in tuples, lists, dicts)
    must be finite: a NaN or inf raises FloatingPointError naming fn and the
    output. In place of the reference's NaN asserts (barf model/base.py:
    125-126)."""
    name = getattr(fn, "__name__", repr(fn))

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, t in enumerate(_floating(out)):
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"{name}: output {i} holds NaN or inf")
        return out

    return wrapper
