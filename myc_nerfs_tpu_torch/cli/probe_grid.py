"""Gather / scatter-add rate probes of the grid encode on one NVIDIA GPU:

    python -m myc_nerfs_tpu_torch.cli.probe_grid

The counterpart of the TPU probe scripts (scripts/probe_r2*.py), at their
shapes: row gathers and scatter-adds of a [4096, 256] f32 table at 2^17
indices, with a marginal rate from two sizes as probe_r2f_scale.py takes
it (2^17 and 2^19 for the gather, 2^16 and 2^18 for the scatter); a bf16
row gather; lane gathers at the TPU probes' 8x128 and 2048x128 (launch
overhead at these sizes) and at 65536x128 (96 MB moved); dynamic shared-memory
scratch from 16 KB to 227 KB and a 228 KB one that must be refused; and
the brick3 encode forward and backward at the Car config's geometry
(configs/ngp/Car.py: 8 level groups, 52 MB of tables) for 262144 uniform
random samples, in Mrows/s, where a row is one (sample, group).

Prints one JSON line per probe: {"probe": ..., "ms": ..., "plain_ms": ...,
"mrows_per_s": ..., "correct": ...} and the shapes. Each kernel is checked
against its plain PyTorch version on the same inputs. Times are device
milliseconds of one call (utils.timing.graph_ms); ``call_ms`` is one call
timed from the host with CUDA events (utils.timing.median_ms, host time
included). The rate records also carry ``library_ms``, one PyTorch call
that computes the same function (``index_select``, ``torch.gather``,
``index_add_``; none for the encode), and ``bound_ms``/``bound_by``, the
H100 bound of the bytes the function must move (utils.timing.roofline).
Needs a CUDA device; without one it exits non-zero and prints no probe.
"""
from __future__ import annotations

import json
import math
import sys
from typing import Callable, Dict, List

import torch

from ..ops import brick_grid as bg
from ..ops.cuda import _build, grid_encode as ge, grid_probe as gp
from ..utils.timing import graph_ms, median_ms, roofline

T, W = 4096, 256
N_RATE = 1 << 17
GATHER_SIZES = (1 << 17, 1 << 19)
SCATTER_SIZES = (1 << 16, 1 << 18)
LANE_SHAPES = ((8, 128), (2048, 128), (65536, 128))
SCRATCH_KB = (16, 32, 64, 100, 200, 227)
REFUSED_KB = 228        # above the 227 KB a Hopper block may have
ENCODE_SAMPLES = 262144  # one 4096-ray x 64-sample chunk
CAR_CONFIG = _build.PKG.parent / "configs" / "ngp" / "Car.py"
# the scatter-add's atomics sum ~32 values per element in no fixed order
SCATTER_TOL = 1e-5


def _rate(n_rows: int, ms: float) -> float:
    return n_rows / ms / 1e3


def _err(out: torch.Tensor, ref: torch.Tensor) -> float:
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return math.inf
    return (out.float() - ref.float()).abs().max().item()


def _probe_gathers(dev, gen, emit) -> None:
    for dtype, sizes in ((torch.float32, GATHER_SIZES), (torch.bfloat16, (N_RATE,))):
        tab = torch.randn((T, W), device=dev, generator=gen).to(dtype)
        name = f"gather_rows_{str(dtype).split('.')[-1]}"
        ms = {}
        for n in sizes:
            idx = torch.randint(0, T, (n,), device=dev, generator=gen, dtype=torch.int32)
            err = _err(gp.gather_rows(tab, idx), gp.gather_rows_reference(tab, idx))
            ms[n] = graph_ms(lambda: gp.gather_rows(tab, idx))
            if n == N_RATE:
                plain = graph_ms(lambda: gp.gather_rows_reference(tab, idx))
                library = graph_ms(lambda: torch.index_select(tab, 0, idx))
                # idx, the distinct rows read, the rows written
                rows_read = torch.unique(idx).numel()
                bound = roofline(0, 4 * n + (rows_read + n) * W * tab.element_size())
                call = median_ms(lambda: gp.gather_rows(tab, idx))
                emit(name, T=T, W=W, N=n, ms=ms[n], call_ms=call, plain_ms=plain,
                     library_ms=library,
                     bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                     mrows_per_s=_rate(n, ms[n]), plain_mrows_per_s=_rate(n, plain),
                     max_abs_err=err, correct=err == 0.0)
            elif err != 0.0:
                emit(name, N=n, max_abs_err=err, correct=False)
        if len(sizes) == 2:
            na, nb = sizes
            emit(f"{name}_marginal", T=T, W=W, N=[na, nb], ms=[ms[na], ms[nb]],
                 mrows_per_s=(nb - na) / (ms[nb] - ms[na]) / 1e3, correct=True)


def _probe_scatter(dev, gen, emit) -> None:
    ms = {}
    for n in SCATTER_SIZES + (N_RATE,):
        idx = torch.randint(0, T, (n,), device=dev, generator=gen, dtype=torch.int32)
        val = torch.randn((n, W), device=dev, generator=gen)
        out = gp.scatter_add_rows(idx, val, T)
        ref = gp.scatter_add_rows_reference(idx, val, T)
        err = (out - ref).abs().max().item()
        tol = SCATTER_TOL * max(1.0, ref.abs().max().item())
        ms[n] = graph_ms(lambda: gp.scatter_add_rows(idx, val, T))
        if n == N_RATE:
            plain = graph_ms(lambda: gp.scatter_add_rows_reference(idx, val, T))
            library = graph_ms(lambda: torch.zeros((T, W), device=dev).index_add_(0, idx, val))
            # idx and val read, the whole [T, W] sum written
            bound = roofline(n * W, 4 * n + 4 * n * W + 4 * T * W)
            call = median_ms(lambda: gp.scatter_add_rows(idx, val, T))
            emit("scatter_add_rows_f32", T=T, W=W, N=n, ms=ms[n], call_ms=call,
                 plain_ms=plain,
                 library_ms=library, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                 mrows_per_s=_rate(n, ms[n]), plain_mrows_per_s=_rate(n, plain),
                 max_abs_err=err, tol=tol, correct=err <= tol)
        elif err > tol:
            emit("scatter_add_rows_f32", N=n, max_abs_err=err, tol=tol, correct=False)
    na, nb = SCATTER_SIZES
    emit("scatter_add_rows_f32_marginal", T=T, W=W, N=[na, nb], ms=[ms[na], ms[nb]],
         mrows_per_s=(nb - na) / (ms[nb] - ms[na]) / 1e3, correct=True)


def _probe_lanes(dev, gen, emit) -> None:
    for r, c in LANE_SHAPES:
        tab = torch.randn((r, c), device=dev, generator=gen)
        idx = torch.randint(0, c, (r, c), device=dev, generator=gen, dtype=torch.int32)
        err = _err(gp.gather_lanes(tab, idx), gp.gather_lanes_reference(tab, idx))
        ms = graph_ms(lambda: gp.gather_lanes(tab, idx))
        plain = graph_ms(lambda: gp.gather_lanes_reference(tab, idx))
        idx64 = idx.long()  # torch.gather takes int64 indices
        library = graph_ms(lambda: torch.gather(tab, 1, idx64))
        # idx, the distinct elements read, the output written
        read = torch.unique(idx64 + c * torch.arange(r, device=dev)[:, None]).numel()
        bound = roofline(0, 4 * (2 * r * c + read))
        call = median_ms(lambda: gp.gather_lanes(tab, idx))
        emit(f"gather_lanes_{r}x{c}", ms=ms, call_ms=call, plain_ms=plain,
             library_ms=library,
             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
             gelem_per_s=r * c / ms / 1e6, max_abs_err=err, correct=err == 0.0)


def _probe_scratch(dev, emit) -> None:
    for kb in SCRATCH_KB:
        err = _err(gp.smem_scratch(kb * 1024, dev), gp.smem_scratch_reference(kb * 1024, dev))
        ms = graph_ms(lambda: gp.smem_scratch(kb * 1024, dev))
        call = median_ms(lambda: gp.smem_scratch(kb * 1024, dev))
        plain = graph_ms(lambda: gp.smem_scratch_reference(kb * 1024, dev))
        # its output, one float, is all it must write to device memory
        bound = roofline(0, 4)
        emit(f"smem_scratch_{kb}KB", bytes=kb * 1024, ms=ms, call_ms=call, plain_ms=plain,
             library_ms=None, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
             max_abs_err=err, correct=err == 0.0)
    try:
        gp.smem_scratch(REFUSED_KB * 1024, dev)
    except RuntimeError as e:
        emit(f"smem_scratch_{REFUSED_KB}KB", bytes=REFUSED_KB * 1024, refused=True,
             error=str(e)[:200], correct=True)
    else:
        emit(f"smem_scratch_{REFUSED_KB}KB", bytes=REFUSED_KB * 1024, refused=False,
             correct=False)


def _probe_encode(dev, gen, emit) -> None:
    from ..core.config import load_config
    from . import run_net

    trainer, _ = run_net.build_trainer(load_config(str(CAR_CONFIG)), gen, device=dev)
    model = trainer.model
    cfg, levels, groups = model.cfg.grid, model.levels, model.groups
    dtype = model.compute_dtype or torch.float32
    tables = [torch.rand(t.shape, device=dev, generator=gen) * 2 - 1 for t in model.tables]
    pos = torch.rand((ENCODE_SAMPLES, 3), device=dev, generator=gen)
    rows = ENCODE_SAMPLES * len(groups.groups)
    shape = dict(samples=ENCODE_SAMPLES, groups=len(groups.groups),
                 levels=levels.n_levels, dtype=str(dtype).split(".")[-1])
    with torch.no_grad():
        out = ge.brick_encode(tables, pos, cfg, levels, groups, dtype)
        ref = bg.paired_encode_reference(tables, pos, cfg, levels, groups, dtype)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ge.FWD_TOL[dtype] * max(1.0, ref.float().abs().max().item())
        ms = graph_ms(lambda: ge.brick_encode(tables, pos, cfg, levels, groups, dtype))
        plain = graph_ms(lambda: bg.paired_encode_reference(tables, pos, cfg, levels,
                                                            groups, dtype))
        call = median_ms(lambda: ge.brick_encode(tables, pos, cfg, levels, groups, dtype))
    emit("brick_encode_fwd", **shape, ms=ms, call_ms=call, plain_ms=plain,
         mrows_per_s=_rate(rows, ms),
         plain_mrows_per_s=_rate(rows, plain), max_abs_err=err, tol=tol,
         correct=err <= tol)
    g = torch.randn(out.shape, device=dev, generator=gen).to(out.dtype)
    grads = ge.brick_encode_backward(tables, pos, g, cfg, levels, groups, dtype)
    refs = bg.paired_encode_backward_reference(tables, pos, g, cfg, levels, groups, dtype)
    ok, worst = True, 0.0
    for a, b in zip(grads, refs):
        e = (a - b).abs().max().item()
        ok &= e <= ge.BWD_TOL * max(1e-30, b.abs().max().item())
        worst = max(worst, e)
    ms = graph_ms(lambda: ge.brick_encode_backward(tables, pos, g, cfg, levels, groups,
                                                   dtype))
    plain = graph_ms(lambda: bg.paired_encode_backward_reference(tables, pos, g, cfg,
                                                                 levels, groups, dtype))
    call = median_ms(lambda: ge.brick_encode_backward(tables, pos, g, cfg, levels, groups,
                                                      dtype))
    emit("brick_encode_bwd", **shape, ms=ms, call_ms=call, plain_ms=plain,
         mrows_per_s=_rate(rows, ms),
         plain_mrows_per_s=_rate(rows, plain), max_abs_err=worst,
         rtol=ge.BWD_TOL, correct=ok)


def run_probes(log: Callable[[str], None] = print, seed: int = 0) -> List[Dict]:
    """Run every probe on the current CUDA device; returns the probe
    records, each also passed to ``log`` as one JSON line."""
    if not torch.cuda.is_available():
        raise RuntimeError("the grid probes need a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    records: List[Dict] = []

    def emit(name: str, **kw) -> None:
        records.append({"probe": name, **kw})
        log(json.dumps(records[-1]))

    _probe_gathers(dev, gen, emit)
    _probe_scatter(dev, gen, emit)
    _probe_lanes(dev, gen, emit)
    _probe_scratch(dev, emit)
    _probe_encode(dev, gen, emit)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_grid: torch.cuda.is_available() is false: the probes need "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    records = run_probes(lambda line: print(line, flush=True))
    return 0 if all(r["correct"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
