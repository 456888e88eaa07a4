"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, each ending in one line (a failure exits non-zero):
1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles the three sources under myc_nerfs_tpu_torch/csrc/
   (fused_mlp.cu, grid_encode.cu, grid_probe.cu) with nvcc, all at once,
   and prints each one's build time; then counts, in the built libraries'
   SASS (cuobjdump -sass), the tensor-core instructions of the fused-MLP
   kernels, HMMA (mma.sync) in the narrow bf16 ones and HGMMA (wgmma) in
   the wide bf16 chain and dW kernels and the wide f32 forward and dW
   kernels (TF32), which must not be 0, and the global
   reductions (RED) and atomics (ATOM) of the encode backward, which must
   add by RED.
3. kernel: the fused_mlp forward kernel against its plain PyTorch version
   at both NGP MLP shapes (density 32->64->16, rgb 32->64->64->16),
   262144 rows (one 4096-ray x 64-sample chunk), f32 and bf16, TF32 off;
   max abs error against the stated tolerance; the device time of one call
   (kernel_ms, plain_ms, library_ms: CUDA-graph replays, utils.timing.
   graph_ms) and of one call from the host (call_ms, CUDA events);
   library_ms is the cuBLAS chain (torch.mm + relu_ per layer, in the
   dtype); bound_ms and share_of_bound against the H100 bound of the
   bytes or flops (ops/cuda/fused_mlp.py::mlp_work; in f32 the flops of
   three TF32 passes, and beside it the CUDA cores' FMA bound,
   bound_ms_fma).
4. kernel_bwd: the backward kernel (fused_mlp_backward) against
   fused_mlp_backward_reference at the same shapes and rows: dx and every
   dW, with their tolerances, and the same times; library_ms is the cuBLAS
   chain's forward and torch.autograd.grad (the kernel recomputes the
   forward too).
5. kernel_encode / kernel_encode_bwd: the brick3 grid-encode kernels
   (brick_encode, brick_encode_backward) against paired_encode_reference
   and paired_encode_backward_reference on the Car config's 8 level-group
   tables filled with uniform +-1 values, at 262144 positions from a real
   march of one 4096-ray chunk of the Car render, the first of them
   replaced by positions on cell and brick boundaries and at 0 and 1;
   f32 and bf16, with the stated tolerances, device times (graph_ms), the
   time of one call from the host (call_ms) and the bound of the bytes
   this run's positions must move (ops/cuda/grid_encode.py::encode_work).
   The backward is timed with g on every sample and again with g zero off
   the march's valid samples, the train step's gradient pattern
   (ms_masked); a diagnostic line splits both times by level group (g
   zero outside one group's columns).
6. probe: the gather / scatter-add rate probes of cli/probe_grid.py, one
   line each, with their library calls and bounds; every probe must be
   correct.
7. slice: run_net.build_trainer on configs/ngp/Car.py (L16F2, 2^19,
   aabb_scale 4, fp16 -> bf16 MLPs, use_fully) with seeded random
   weights, 16 occupancy-grid updates, then two 800x800 frames rendered
   along the spherical path; the frames must be finite and not all
   background, and the grid updates and the render must each have run
   the encode and MLP kernels. One chunk of rays is rendered again
   through the plain encode and MLP and compared.
8. train: the same Car config on the synthetic scene (12 views at
   128x128; the model and training settings as the file gives them)
   trained 256 steps through run_net.train_loop: 16 blocks, one grid
   update each, 4096 rays adapting toward 2^18 samples. Loss and params
   must stay finite, at most half the steps may be skipped, the train
   PSNR must rise, and every encode and MLP kernel must have run. Then
   the step's stages are timed, and on one batch every parameter's
   gradient through the kernels is compared with the plain path's
   (use_encode_kernel=False, use_fully=False), and the tables' gradient
   through the encode kernels with the plain encode's under the MLP
   kernels; beside it the backward kernel alone against its plain version
   on the same output gradient, and the count of the encode's output
   elements, and of their gradients, that differ between the two paths.
9. profile (after every counted and timed run, so that no profiler window
   precedes them): one render chunk stage by stage, one 800x800 frame and
   one train block at 4096 rays under torch.profiler, with the device's
   busy share of the wall time (utils/profiling.py); the wide fused-MLP
   backward by kernel in bf16 and in f32, and one train block of the fused
   flagship (phase 13).
10. split: phase 8's encode comparison at many trained states: the config
   trained again from another seed, checked after each of its 16 blocks on
   two batches; one line per check and a summary.
11. kernel_wide / kernel_wide_bwd (after phase 4): the wide fused-MLP
   kernels on OriginNeRF's fused backbone chain [64, 257 x 8] (the
   wrapper pads it to [64, 272 x 8]) at 131072 rows (4096 rays x 32
   samples), bf16 and f32, with the times of phase 3; bound_ms counts the
   257-wide chain the function computes (not the padding), and library_ms
   is the faster cuBLAS chain of the 257-wide and the padded inputs (both
   printed). The forward holds random inputs to TOL. The backward holds
   integer inputs on which every sum is exact (ops/cuda/fused_mlp.py::
   exact_inputs at 16384 rows, where the magnitudes summed into any
   element stay below 2^24, which is checked; any order gives the same
   bits, so dx and every dW must be equal; in f32 the largest |post| and
   |g| of the draw are printed against 3xTF32's exact limits), and random
   inputs: f32 to BWD_TOL, bf16 by the norm of the error (a pre-activation
   within a rounding of 0 flips the ReLU mask between two summation
   orders); it must give the same bits twice. In f32 two planted faults of
   the 3xTF32 products, computed by the plain versions with the fault (one
   TF32 pass of rounded operands; the small(a) big(b) term dropped; in the
   forward, and in dW, the backward's 3xTF32 part), must each be seen by
   the random-input checks forward and backward. In bf16 two planted faults of the
   backward, computed by the plain backward with the fault (dW from the
   gradient rounded to bf16, i.e. no lo term; the dgrad product on the
   unrounded gradient), are read against both checks: the exact check
   must see each of them (the run fails if a fault gives the reference's
   bits), and their norm error on random inputs is printed beside
   WIDE_BWD_NORM_TOL. A NaN, an inf and a NaN whose payload lies in the
   low 13 bits alone planted in x must come out where the plain versions
   put them (wide_non_finite): the same NaN and inf elements forward, the
   same non-finite elements of dx and every dW. The f32 random-input
   backward check runs again at DW_ERR_ROWS, up to 262144 rows, where a
   dW row split sums the most rows (wide_dw_error_by_rows).
12. nerf_train (after phase 8): run_net.build_trainer on
   configs/nerf/budget_synthetic.py as the file gives it (OriginNeRF,
   skips (4,), bf16, lr 1e-3, n_coarse 128, n_compact 32, 4096 rays) on
   the detail scene cut to 12 views at 128x128, 256 steps through
   run_net.train_loop, which saves model.ckpt with the port's msgpack
   codec; the train PSNR must rise, and a fresh trainer restores params,
   Adam state, grid and step bit for bit.
13. flagship_fused: OriginNeRFModel(skips=(), bf16, use_fused) at D=8,
   W=256 through NGPTrainer(model=) on the same scene, 128 steps: the wide
   kernels must run, the PSNR rise, the params stay finite; on
   FLAGSHIP_GRAD_SEEDS batches every parameter's gradient through the
   kernels against the gradient through the plain versions on the card
   (the model's mlp seam: fused_mlp_plain), and the planted faults of
   phase 11 read against the same limit; the same in f32 on a model of its
   own (use_bf16=False, holding the trained weights and grid, no further
   steps) with a limit of its own, FLAGSHIP_F32_GRAD_TOL, and the planted
   f32 faults of phase 11 read against it; one held-out 128x128 view
   rendered through the fused path.
14. hash_march: the non-fused path (grid_impl 'hash', fused_march=False,
   compact_source 'network') trained 64 steps on the blobs scene; the
   PSNR must rise.
Then a JSON line describing each kernel (for the fused MLP and encode
kernels its numbers are the bf16 ones, the Car slice's dtype, summed over
the shapes; ``ms`` is graph_ms, ``call_ms`` median_ms), and last the
result line. Each main-path run (the grid updates, the render, the probes,
the training) starts with every launch count at 0 and reads them right
after it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

from myc_nerfs_tpu_torch.utils import profiling
from myc_nerfs_tpu_torch.utils.timing import graph_ms, median_ms

ROWS = 262144                       # 4096 rays x 64 samples
SHAPES = {"density": (32, 64, 16), "rgb": (32, 64, 64, 16)}
# f32: 32-64-term dot products summed in another order than cuBLAS's, on
# O(1) values. bf16: the output is rounded to bf16 after every layer, so a
# sum that lands on the other side of a rounding boundary shifts an
# intermediate by one bf16 ulp; allow two ulps of the output's scale.
TOL = {torch.float32: lambda scale: 1e-4 * max(1.0, scale),
       torch.bfloat16: lambda scale: 2.0 ** -7 * max(1.0, scale)}
FRAMES, H, W = 2, 800, 800          # configs/ngp/Car.py test split
# backward, against each reference's scale: f32 dx 1e-5 (16-64-term sums in
# another order), f32 dW 1e-4 (a sum over 262144 rows in another order);
# bf16 2 ulps (2^-7), as the forward
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}
TRAIN_STEPS, TRAIN_VIEWS, TRAIN_SIZE = 256, 12, 128
TRAIN_KERNELS = ("fused_mlp", "fused_mlp_bwd", "brick_encode", "brick_encode_bwd")
# the last block's mean train PSNR must beat the first block's by this much
# (dB): half, rounded down, of the 18.7 dB rise (13.0 -> 31.8) of the first
# run of this phase on an H100
PSNR_RISE = 9.0
# kernel path vs plain path gradient, per parameter, as |a-b| / |b| over
# the whole tensor. MLP weights: the plain path's autograd rounds the
# gradient to bf16 (up to 2^-9 of each element) at every layer boundary
# before dW, and the kernel does not; allow two bf16 ulps (2^-7). Tables,
# the encode kernels alone: against the plain encode under the same MLP
# kernels (whose forward agrees bit for bit: both sum in corner order), the
# same contributions added by f32 atomics in another order (1e-5). Tables
# through both kernels against the plain path: their
# gradient is the MLP's dx, whose bf16 elements may each sit one rounding
# away from the plain path's (the tensor cores sum in another order than
# cuBLAS). 15 runs of this phase on an H100 80GB HBM3 at 700 W read 1.4e-5
# to 8.9e-4; the limit is 3.4x the largest.
GRAD_REL_TOL = 2.0 ** -7
TABLE_GRAD_REL_TOL = 1e-5
TABLE_E2E_REL_TOL = 3e-3
ENCODE_RAYS, ENCODE_SAMPLES = 4096, 64   # one chunk of the Car render
BOUNDARY_PER_LEVEL = 1024                # boundary positions per level
SPLIT_BATCHES = 2                        # batches checked at each state (phase 10)
# the narrow bf16 kernels run mma.sync (SASS HMMA), the wide bf16 ones and
# the wide f32 forward and dW wgmma (HGMMA; TF32 for f32)
SASS_KERNELS = ("fused_mlp_fwd_bf16_kernel", "fused_mlp_bwd_bf16_kernel")
WGMMA_KERNELS = ("fused_mlp_wide_bf16_kernel", "fused_mlp_wide_dw_bf16_kernel",
                 "fused_mlp_wide_tf32_kernel", "fused_mlp_wide_dw_tf32_kernel")
# OriginNeRF's fused backbone: 64 -> 257 x 8 with the biases folded in, at
# the flagship's train step (4096 rays x n_compact 32)
WIDE_CHAIN = (64,) + (257,) * 8
WIDE_ROWS = 131072
# the f32 backward's random-input check also at these rows (phase 11)
DW_ERR_ROWS = (64, 1024, 16384, WIDE_ROWS, 2 * WIDE_ROWS)
# the exact-input check's rows: at 16384 rows the magnitudes summed into
# one element stay below 2^24 (4.3e6 for this draw on the CPU), so every
# order sums exactly; at 131072 they do not (4.0e7)
WIDE_EXACT_ROWS = 16384
EXACT_LIMIT = 2.0 ** 24
# random bf16 inputs, backward: |a - b| / |b| over each tensor. The ReLU
# masks of two summation orders differ where a pre-activation lies within a
# rounding of 0, and a flipped mask moves that row's gradient by a whole
# term (chip runs on an H100 read dx 7.6e-3, dW 8.7e-3). The planted
# faults below read 2.8e-3 to 5.1e-3 here, under the limit: this check
# cannot see them, the exact-input check (elements differing) does
WIDE_BWD_NORM_TOL = 2.0 ** -5
# planted faults of the bf16 backward (planted_backward)
FAULTS = ("no_lo", "unrounded_g")
# planted faults of the f32 kernels' 3xTF32 products (fused_mlp.mm_3xtf32):
# one TF32 pass of operands rounded to TF32, and the small(a) big(b) term
# dropped
F32_FAULTS = ("one_pass", "no_small_a")
# 3xTF32 is exact on a product of an operand of at most 11 significant bits
# and one of at most 22: integers below 2^11 and 2^22
TF32_EXACT_BITS = (11, 22)
# phase 11's non-finite check: x rows that get a NaN, an inf and a NaN
# whose payload lies in the low 13 bits alone (f32 0x7f800001, bf16 0x7f81)
NONFINITE_ROWS = (5, 4100, 9000)
NERF_VIEWS, NERF_SIZE, NERF_STEPS, FLAGSHIP_STEPS, HASH_STEPS = 12, 128, 256, 128, 64
# the train PSNR of the last block must beat the first block's by this much
# (dB), half, rounded down, of the first chip run's rise on an H100 80GB
# HBM3 at 700 W: nerf_train 11.44 -> 16.62, flagship_fused 11.30 -> 12.15
# in its 128 steps, hash_march 11.91 -> 12.78 in its 64 (the vertex hash
# at lr 1e-2 learns slowly at first). These phases show that training
# moves; cli/quality_scale.py measures quality
NERF_PSNR_RISE = 2.5
FLAGSHIP_PSNR_RISE = 0.4
HASH_PSNR_RISE = 0.4
# flagship gradient, kernels vs plain versions on the card: |a-b|/|b| per
# parameter, for the mask flips above through 8 layers, on this many
# batches. A run on an H100 80GB HBM3 at 700 W read 8.4e-4 to 1.42e-3 over
# its 8 batches; the limit is ~4x the largest. The planted faults read
# 5.5e-4 and 6.1e-4 there, inside the kernels' own spread: only phase 11's
# exact check sees them
FLAGSHIP_GRAD_SEEDS = 8
FLAGSHIP_GRAD_TOL = 6e-3
# the same in f32 (an f32 model holding the trained bf16 weights): the
# kernels' 3xTF32 forward and dW against the plain f32 GEMMs. Two runs on an
# H100 80GB HBM3 at 700 W read 1.85e-5 to 3.71e-5 over their 8 batches; the
# limit is ~4x the largest. The planted f32 faults read against it:
# no_small_a 3.53e-4 (seen), one_pass 1.34e-5 (not: its rounding errors, to
# nearest, average out over the rows of dW); phase 11's random-input checks
# see both
FLAGSHIP_F32_GRAD_TOL = 1.5e-4
# the encode backward's instance on the Car path (F = 2, bf16), mangled
ENCODE_BWD_SASS = "brick_encode_bwd_kernelILi2ELb1E"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def counters():
    """Every kernel wrapper of the port, by the kernel's name in the JSON
    line; each carries its launch count."""
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm
    from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge
    from myc_nerfs_tpu_torch.ops.cuda import grid_probe as gp

    return {"fused_mlp": fm.fused_mlp, "fused_mlp_bwd": fm.fused_mlp_backward,
            "fused_mlp_wide": fm.fused_mlp_wide,
            "fused_mlp_wide_bwd": fm.fused_mlp_wide_backward,
            "brick_encode": ge.brick_encode,
            "brick_encode_bwd": ge.brick_encode_backward,
            "gather_rows": gp.gather_rows, "gather_lanes": gp.gather_lanes,
            "scatter_add_rows": gp.scatter_add_rows, "smem_scratch": gp.smem_scratch}


def reset_launches() -> None:
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def phase_build() -> None:
    """nvcc on every source at once; each build is printed with its time."""
    from myc_nerfs_tpu_torch.ops.cuda import _build
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm
    from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge
    from myc_nerfs_tpu_torch.ops.cuda import grid_probe as gp

    modules = (fm, ge, gp)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        builds = [pool.submit(m.build) for m in modules]
        results = [b.result() for b in builds]
    root = _build.PKG.parent
    for m, (path, secs) in zip(modules, results):
        print(f"build: {m.SOURCE.relative_to(root)} -> {path.relative_to(root)} "
              f"in {secs:.2f} s", flush=True)
    print(f"build: all sources in {time.perf_counter() - t0:.2f} s (in parallel)",
          flush=True)
    # the bf16 MLP kernels must run on the tensor cores: HMMA (mma.sync) in
    # the narrow kernels' SASS, HGMMA (wgmma) in the wide ones'; the encode
    # backward adds by reductions (RED), not returning atomics
    hmma = sass_counts(results[0][0], SASS_KERNELS, ("HMMA",))
    hgmma = sass_counts(results[0][0], WGMMA_KERNELS, ("HGMMA",))
    red = sass_counts(results[1][0], (ENCODE_BWD_SASS,), ("RED", "ATOM"))[ENCODE_BWD_SASS]
    print("sass: HMMA instructions (cuobjdump -sass) "
          + " ".join(f"{k}={n['HMMA']}" for k, n in hmma.items())
          + "; HGMMA " + " ".join(f"{k}={n['HGMMA']}" for k, n in hgmma.items())
          + f"; brick_encode_bwd_kernel<F=2, bf16> RED={red['RED']} ATOM={red['ATOM']}",
          flush=True)
    if not all(n["HMMA"] for n in hmma.values()):
        fail(f"a narrow bf16 fused-MLP kernel has no tensor-core instruction: {hmma}")
    if not all(n["HGMMA"] for n in hgmma.values()):
        fail(f"a wide bf16 fused-MLP kernel has no wgmma instruction: {hgmma}")
    if not red["RED"]:
        fail(f"the encode backward adds by no RED instruction: {red}")


def sass_counts(lib: Path, kernels, opcodes) -> dict:
    """Instructions of each family in ``opcodes`` (HMMA.16816... is HMMA;
    ATOMG counts as ATOM) in the SASS of each kernel whose (mangled) name
    contains one of ``kernels``."""
    from myc_nerfs_tpu_torch.ops.cuda import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts = {k: {op: 0 for op in opcodes} for k in kernels}
    kernel = None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = next((k for k in kernels if k in line), None)
        elif kernel and "*/" in line:
            # "/*0a40*/   @P0 RED.E.ADD.F32... ;": the opcode after any predicate
            words = line.split("*/", 1)[1].split()
            words = words[1:] if words and words[0].startswith("@") else words
            family = words[0].split(".")[0] if words else ""
            for op in opcodes:
                counts[kernel][op] += family in (op, op + "G")
    return counts


def library_chain(x, ws):
    """The cuBLAS yardstick of the fused MLP (library_ms): torch.mm and
    relu_ per layer in x's dtype. Timed here only; the port never calls it."""
    h = x
    for i, w in enumerate(ws):
        h = torch.mm(h, w)
        if i + 1 < len(ws):
            h = h.relu_()
    return h


def mlp_inputs(widths, dtype, g):
    x = torch.rand((ROWS, widths[0]), device="cuda", generator=g).to(dtype)
    ws = [(torch.randn((widths[i], widths[i + 1]), device="cuda",
                       generator=g) / widths[i] ** 0.5).to(dtype)
          for i in range(len(widths) - 1)]
    return x, ws


def bound_fields(t_k: float, work: dict) -> str:
    """The kernel's time beside its H100 bound (mlp_work, encode_work); in
    f32 beside both: three TF32 passes on the tensor cores (bound_ms) and
    the CUDA cores' FMAs (bound_ms_fma)."""
    out = (f"kernel_ms={t_k:.4f} bound_ms={work['bound_ms']:.4f} "
           f"bound_by={work['bound_by']} share_of_bound={work['bound_ms'] / t_k:.3f}")
    if "bound_ms_fma" in work:
        out += (f" bound_ms_fma={work['bound_ms_fma']:.4f} "
                f"share_of_fma_bound={work['bound_ms_fma'] / t_k:.3f}")
    return out


def add_bf16(acc: dict, err: float, t_k: float, t_c: float, t_p: float, t_l: float,
             work: dict) -> None:
    """Sum the bf16 numbers of the shapes into one JSON entry."""
    acc["max_abs_err"] = max(acc.get("max_abs_err", 0.0), err)
    for k, v in (("ms", t_k), ("call_ms", t_c), ("plain_ms", t_p), ("library_ms", t_l),
                 ("bound_ms", work["bound_ms"])):
        acc[k] = acc.get(k, 0.0) + v
    acc["bound_by"] = work["bound_by"]


def phase_kernel(fm) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, widths in SHAPES.items():
            x, ws = mlp_inputs(widths, dtype, g)
            with torch.no_grad():
                y = fm.fused_mlp(x, ws)
                ref = fm.fused_mlp_reference(x, ws)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = TOL[dtype](scale)
                t_k = graph_ms(lambda: fm.fused_mlp(x, ws))
                t_c = median_ms(lambda: fm.fused_mlp(x, ws))
                t_p = graph_ms(lambda: fm.fused_mlp_reference(x, ws))
                t_l = graph_ms(lambda: library_chain(x, ws))
            work = fm.mlp_work(widths, ROWS, dtype)
            ok = err <= tol
            print(f"kernel: fused_mlp {name} {'x'.join(map(str, widths))} "
                  f"{dtype_name(dtype)} rows={ROWS} tf32=off "
                  f"max_abs_err={err:.3e} tol={tol:.3e} "
                  f"{'ok' if ok else 'BREACH'} {bound_fields(t_k, work)} call_ms={t_c:.4f} "
                  f"plain_ms={t_p:.4f} library_ms={t_l:.4f}", flush=True)
            if not ok:
                fail(f"fused_mlp {name} {dtype}: max abs err {err} > {tol}")
            if dtype == torch.bfloat16:  # the Car slice's dtype
                add_bf16(out, err, t_k, t_c, t_p, t_l, work)
    return out


def phase_kernel_bwd(fm) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, widths in SHAPES.items():
            x, ws = mlp_inputs(widths, dtype, g)
            gy = torch.randn((ROWS, widths[-1]), device="cuda", generator=g).to(dtype)
            dx, dws = fm.fused_mlp_backward(x, ws, gy)
            dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, gy)
            torch.cuda.synchronize()
            tol_dx, tol_dw = BWD_TOL[dtype]
            errs, ok, worst = [], True, 0.0
            for i, (a, b) in enumerate([(dx, dx_ref)] + list(zip(dws, dws_ref))):
                err = (a.float() - b.float()).abs().max().item()
                tol = (tol_dx if i == 0 else tol_dw) * max(1.0, b.float().abs().max().item())
                errs.append(f"{'dx' if i == 0 else f'dW{i - 1}'}={err:.3e}/{tol:.3e}")
                ok &= err <= tol
                worst = max(worst, err)
            # the partial dWs are summed in a fixed order: the same bits again
            dx2, dws2 = fm.fused_mlp_backward(x, ws, gy)
            same = torch.equal(dx, dx2) and all(map(torch.equal, dws, dws2))
            ok &= same
            xl = x.clone().requires_grad_()
            wl = [w.clone().requires_grad_() for w in ws]
            t_k = graph_ms(lambda: fm.fused_mlp_backward(x, ws, gy))
            t_c = median_ms(lambda: fm.fused_mlp_backward(x, ws, gy))
            t_p = graph_ms(lambda: fm.fused_mlp_backward_reference(x, ws, gy))
            t_l = graph_ms(lambda: torch.autograd.grad(library_chain(xl, wl), [xl] + wl, gy))
            work = fm.mlp_work(widths, ROWS, dtype, backward=True)
            print(f"kernel_bwd: fused_mlp_backward {name} "
                  f"{'x'.join(map(str, widths))} {dtype_name(dtype)} "
                  f"rows={ROWS} tf32=off max_abs_err/tol {' '.join(errs)} "
                  f"deterministic={same} {'ok' if ok else 'BREACH'} "
                  f"{bound_fields(t_k, work)} call_ms={t_c:.4f} plain_ms={t_p:.4f} "
                  f"library_ms={t_l:.4f}", flush=True)
            if not ok:
                fail(f"fused_mlp_backward {name} {dtype}: {errs}")
            if dtype == torch.bfloat16:
                add_bf16(out, worst, t_k, t_c, t_p, t_l, work)
    return out


def encode_inputs():
    """The Car model (seeded random weights, two grid updates), its 8
    level-group tables refilled with uniform +-1 values, 262144 positions
    (one 4096-ray x 64-sample chunk of a real march of the Car render, the
    first of them replaced by positions on each level's cell and brick
    boundaries, and by the corners of the unit cube) and the march's valid
    mask over them."""
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.geom import rays as rays_lib
    from myc_nerfs_tpu_torch.geom.camera_path import path_spherical
    from myc_nerfs_tpu_torch.render.ngp_render import march_rays_fused

    gen = torch.Generator(device="cuda").manual_seed(2)
    trainer, _ = run_net.build_trainer(load_config("configs/ngp/Car.py"), gen,
                                       device="cuda")
    model = trainer.model
    with torch.no_grad():
        for _ in range(2):
            trainer.state = trainer.state._replace(
                occ=trainer.grid_update(trainer.state.occ, gen))
        pose = run_net.path_pose(path_spherical(FRAMES)[0]).to("cuda")
        d = rays_lib.get_ray_directions(H, W, (W * 0.6, W * 0.6), device="cuda")
        rays_d = d.reshape(-1, 3)[::150][:ENCODE_RAYS] @ pose[:3, :3].T
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o = pose[:3, 3].expand(rays_d.shape)
        marched = march_rays_fused(trainer.occ_cfg, trainer.rcfg, trainer.state.occ,
                                   rays_o, rays_d, n_samples=ENCODE_SAMPLES)
    pos = marched.positions.reshape(-1, 3).contiguous()
    edges = []
    for sc in model.levels.scales:
        k = torch.randint(0, math.ceil(sc) + 2, (BOUNDARY_PER_LEVEL, 3),
                          device="cuda", generator=gen)
        brick = torch.rand(k.shape, device="cuda", generator=gen) < 0.5
        k = torch.where(brick, k - k % 4, k)
        edges.append((k.float() - 0.5) / sc)  # pos * sc + 0.5 lands on k
    c = torch.arange(8, device="cuda")
    edges.append(torch.stack([c & 1, (c >> 1) & 1, (c >> 2) & 1], -1).float())
    edges = torch.cat(edges).clamp(0.0, 1.0)
    pos[:edges.shape[0]] = edges
    tables = [torch.rand(t.shape, device="cuda", generator=gen) * 2 - 1
              for t in model.tables]
    return model, tables, pos, marched.valid.reshape(-1)


def encode_bwd_by_group(tables, pos, g, g_valid, geo, dtype) -> dict:
    """The backward's device ms with g zero outside one level group's
    columns, for g (``all``) and g zero off valid (``valid``), by group
    name (L<first>-<last>)."""
    from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge

    cfg, levels, groups = geo
    F = cfg.n_features
    parts = {"all": {}, "valid": {}}
    for members in groups.groups:
        name = f"L{members[0]}" + (f"-{members[-1]}" if len(members) > 1 else "")
        cols = torch.zeros(cfg.out_dim, dtype=dtype, device=g.device)
        for lv in members:
            cols[lv * F:(lv + 1) * F] = 1
        for key, gg in (("all", g), ("valid", g_valid)):
            g_grp = gg * cols
            parts[key][name] = graph_ms(
                lambda: ge.brick_encode_backward(tables, pos, g_grp, *geo, dtype))
    return parts


def phase_kernel_encode():
    from myc_nerfs_tpu_torch.ops import brick_grid as bg
    from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge

    model, tables, pos, valid = encode_inputs()
    geo = (model.cfg.grid, model.levels, model.groups)
    shape = (f"Car {len(model.groups.groups)} groups L{model.levels.n_levels}"
             f"F{model.cfg.grid.n_features} rows={pos.shape[0]} (march, "
             f"{valid.float().mean().item():.3f} valid, + boundaries) tables=uniform+-1")
    gen = torch.Generator(device="cuda").manual_seed(3)
    fwd, bwd = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            out = ge.brick_encode(tables, pos, *geo, dtype)
            ref = bg.paired_encode_reference(tables, pos, *geo, dtype)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            differ = int((out != ref).sum())
            tol = ge.FWD_TOL[dtype] * max(1.0, ref.float().abs().max().item())
            t_k = graph_ms(lambda: ge.brick_encode(tables, pos, *geo, dtype))
            t_c = median_ms(lambda: ge.brick_encode(tables, pos, *geo, dtype))
            t_p = graph_ms(lambda: bg.paired_encode_reference(tables, pos, *geo, dtype))
        work = ge.encode_work(tables, pos, *geo, dtype)
        ok = err <= tol and out.dtype == dtype and bool(torch.isfinite(out).all())
        print(f"kernel_encode: brick_encode {shape} {dtype_name(dtype)} "
              f"max_abs_err={err:.3e} tol={tol:.3e} differing={differ} of {out.numel()} "
              f"{'ok' if ok else 'BREACH'} "
              f"{bound_fields(t_k, work)} call_ms={t_c:.4f} plain_ms={t_p:.4f} "
              f"library_ms=null", flush=True)
        if not ok:
            fail(f"brick_encode {dtype}: max abs err {err} > {tol}")
        g = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
        grads = ge.brick_encode_backward(tables, pos, g, *geo, dtype)
        refs = bg.paired_encode_backward_reference(tables, pos, g, *geo, dtype)
        torch.cuda.synchronize()
        errs, ok, worst = [], True, 0.0
        for i, (a, b) in enumerate(zip(grads, refs)):
            e = (a - b).abs().max().item()
            tol = ge.BWD_TOL * b.abs().max().item()
            errs.append(f"table{i}={e:.3e}/{tol:.3e}")
            ok &= e <= tol and a.shape == b.shape
            worst = max(worst, e)
        b_k = graph_ms(lambda: ge.brick_encode_backward(tables, pos, g, *geo, dtype))
        g_valid = g * valid[:, None].to(dtype)  # the train step's pattern
        b_m = graph_ms(lambda: ge.brick_encode_backward(tables, pos, g_valid, *geo, dtype))
        b_c = median_ms(lambda: ge.brick_encode_backward(tables, pos, g, *geo, dtype))
        b_p = graph_ms(lambda: bg.paired_encode_backward_reference(tables, pos, g, *geo,
                                                                   dtype))
        b_work = ge.encode_work(tables, pos, *geo, dtype, backward=True)
        print(f"kernel_encode_bwd: brick_encode_backward {shape} {dtype_name(dtype)} "
              f"max_abs_err/tol {' '.join(errs)} (tol {ge.BWD_TOL:g} of each table "
              f"gradient's scale: the same contributions, added by f32 atomics "
              f"in no fixed order) {'ok' if ok else 'BREACH'} {bound_fields(b_k, b_work)} "
              f"ms_masked={b_m:.4f} (g zero off the {int(valid.sum())} valid samples) "
              f"call_ms={b_c:.4f} plain_ms={b_p:.4f} library_ms=null", flush=True)
        if not ok:
            fail(f"brick_encode_backward {dtype}: {errs}")
        if dtype == torch.bfloat16:  # the Car slice's dtype
            parts = encode_bwd_by_group(tables, pos, g, g_valid, geo, dtype)
            print(f"kernel_encode_bwd_groups: {dtype_name(dtype)} device ms with g zero "
                  f"outside one group's columns; " + "; ".join(
                      f"g={key}: " + " ".join(f"{n}={t:.4f}" for n, t in ts.items())
                      + f" sum={sum(ts.values()):.4f}" for key, ts in parts.items()),
                  flush=True)
            fwd = {"max_abs_err": err, "ms": t_k, "call_ms": t_c, "plain_ms": t_p,
                   "library_ms": None,
                   "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
            bwd = {"max_abs_err": worst, "ms": b_k, "ms_masked": b_m, "call_ms": b_c,
                   "plain_ms": b_p, "library_ms": None,
                   "bound_ms": b_work["bound_ms"], "bound_by": b_work["bound_by"]}
    return fwd, bwd


# each probe kernel's entry in the JSON line: the probe record it takes its
# numbers from
PROBE_RECORDS = {"gather_rows": "gather_rows_float32",
                 "gather_lanes": "gather_lanes_2048x128",
                 "scatter_add_rows": "scatter_add_rows_f32",
                 "smem_scratch": "smem_scratch_227KB"}


def phase_probe():
    from myc_nerfs_tpu_torch.cli import probe_grid

    reset_launches()
    records = probe_grid.run_probes(lambda line: print(f"probe: {line}", flush=True))
    launches = read_launches()
    bad = [r["probe"] for r in records if not r["correct"]]
    if bad:
        fail(f"probes not correct: {bad}")
    by_name = {r["probe"]: r for r in records}
    stats = {}
    for kernel, name in PROBE_RECORDS.items():
        if launches[kernel] == 0:
            fail(f"the probes did not run the {kernel} kernel")
        r = by_name[name]
        stats[kernel] = {"launches": launches[kernel],
                         **{k: r[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                              "library_ms", "bound_ms", "bound_by")}}
    return stats


def chunk_rays(pose):
    """About 4096 rays spread over an 800x800 frame seen from pose."""
    from myc_nerfs_tpu_torch.geom import rays as rays_lib

    pose = pose.to("cuda")
    d = rays_lib.get_ray_directions(H, W, (W * 0.6, W * 0.6), device="cuda")
    rays_d = d.reshape(-1, 3)[::157][:4096] @ pose[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return pose[:3, 3].expand(rays_d.shape), rays_d


def phase_slice(card: str):
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.geom.camera_path import path_spherical

    cfg = load_config("configs/ngp/Car.py")
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer, _ = run_net.build_trainer(cfg, gen, device="cuda")
    model = trainer.model
    grid = model.cfg.grid
    if not (model.cfg.use_bf16 and model.cfg.use_fully and grid.n_levels == 16
            and grid.n_features == 2 and grid.log2_hashmap_size == 19
            and trainer.rcfg.aabb_scale == 4 and model.use_encode_kernel):
        fail(f"Car config did not build as expected: {model.cfg}")
    intr = torch.tensor([[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1.0]])
    poses = [run_net.path_pose(p) for p in path_spherical(FRAMES)]

    # the main path: grid updates, then the render; each runs the kernels
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(16):
        trainer.state = trainer.state._replace(
            occ=trainer.grid_update(trainer.state.occ, gen))
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    grid_launches = read_launches()
    occ_frac = trainer.state.occ.bitfield.float().mean().item()

    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    frames = [trainer.render_image(p, intr, H, W)[0] for p in poses]
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rgb = torch.stack(frames)
    bg = torch.tensor(trainer.cfg.background_color, device="cuda")
    non_bg = ((rgb - bg).abs().amax(-1) > 1e-3).float().mean().item()
    rays_s = FRAMES * H * W / t_render
    print(f"slice: Car L16F2 2^19 aabb_scale=4 bf16 use_fully "
          f"grid_updates=16 ({t_grid:.2f} s) occupied={occ_frac:.4f} "
          f"frames={FRAMES}x{H}x{W} render_s={t_render:.3f} "
          f"rays_per_s={rays_s:.0f} peak_mem_gib={peak_gib:.2f} (held before: {held_gib:.2f}) "
          f"non_background={non_bg:.4f} "
          f"grid_update_launches fused_mlp={grid_launches['fused_mlp']} "
          f"brick_encode={grid_launches['brick_encode']} "
          f"render_launches fused_mlp={launches['fused_mlp']} "
          f"brick_encode={launches['brick_encode']} [{card}]", flush=True)
    if tuple(rgb.shape) != (FRAMES, H, W, 3) or not torch.isfinite(rgb).all():
        fail("render output is not finite or has the wrong shape")
    if non_bg < 1e-3:
        fail("render is all background")
    for name, counts in (("grid update", grid_launches), ("render", launches)):
        if counts["fused_mlp"] == 0 or counts["brick_encode"] == 0:
            fail(f"the {name} did not run the fused_mlp and brick_encode kernels")

    # the same rays through the plain encode and MLP: the slice agrees with
    # its reference path (bf16 both ways; see TOL for the rounding allowance)
    from myc_nerfs_tpu_torch.render.ngp_render import render_rays_ngp

    rays_o, rays_d = chunk_rays(poses[0])
    outs = []
    with torch.no_grad():
        for kernels in (True, False):
            model.use_encode_kernel = model.net.use_fully = kernels
            outs.append(render_rays_ngp(trainer.occ_cfg, trainer.rcfg, model,
                                        trainer.state.occ, rays_o, rays_d, bg).rgb)
    model.use_encode_kernel = model.net.use_fully = True
    diff = (outs[0] - outs[1]).abs().amax(-1)
    print(f"slice: kernels vs plain encode and MLP on {rays_d.shape[0]} rays: "
          f"max_abs_rgb_diff={diff.max().item():.3e} "
          f"rays_over_1e-2={(diff > 1e-2).float().mean().item():.5f}", flush=True)
    if (diff > 1e-2).float().mean().item() > 1e-3:
        fail("kernel and plain renders disagree")

    return grid_launches, launches


def short_name(kernel: str) -> str:
    for noise in ("void ", "(anonymous namespace)::", "at::native::", "std::"):
        kernel = kernel.replace(noise, "")
    return kernel[:72]


def print_profile(what: str, prof: dict, card: str, per: int = 1, wall_ms=None) -> None:
    """One line: device ms (per step when per > 1), the device's busy share
    of the wall time (of ``wall_ms``, timed without the profiler, when
    given), and the largest device events by name."""
    wall = prof["wall_ms"] if wall_ms is None else wall_ms
    print(f"{what}: torch.profiler device_ms={prof['device_ms'] / per:.4f} "
          f"wall_ms={wall / per:.4f} (profiler on: {prof['wall_ms'] / per:.4f}) "
          f"busy_share={prof['device_ms'] / wall:.3f} events={prof['events']} "
          + " | ".join(f"{short_name(k)}: {v[0] / per:.4f}ms/{v[1]}"
                     for k, v in prof["kernels"].items())
          + f" other={prof['other_ms'] / per:.4f}ms [{card}]", flush=True)


def phase_train(card: str):
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.data.blender import RayBatcher

    cfg = load_config("configs/ngp/Car.py")
    cfg.update(synthetic=True, synthetic_views=TRAIN_VIEWS, synthetic_size=TRAIN_SIZE)
    data, h, w = run_net.load_data(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer, tcfg = run_net.build_trainer(cfg, gen, device="cuda")
    model = trainer.model
    if not (model.cfg.use_bf16 and model.cfg.use_fully and tcfg.skip_nonfinite
            and tcfg.fp16_grads and trainer.rcfg.n_compact == 64
            and tcfg.lr == 0.1 and tcfg.ema_decay == 0.95
            and tcfg.n_rays_per_batch == 4096 and tcfg.target_batch_size == 1 << 18):
        fail(f"Car train config did not build as expected: {model.cfg} {tcfg}")

    # time every block and grid update of the loop (synchronised)
    blocks, grid_s = [], []
    train_block, grid_update = trainer.train_block, trainer.grid_update

    def timed_block(rays_o, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_block(rays_o, *a, **k)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0, rays_o.shape[0], rays_o.shape[1]))
        return m

    def timed_grid(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grid_update(*a, **k)
        torch.cuda.synchronize()
        grid_s.append(time.perf_counter() - t0)
        return out

    trainer.train_block, trainer.grid_update = timed_block, timed_grid
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist = run_net.train_loop(trainer, tcfg, data, TRAIN_STEPS, gen,
                              log=lambda msg: print(f"train: {msg}", flush=True))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    trainer.train_block, trainer.grid_update = train_block, grid_update

    loss = [m["loss"].float().mean().item() for m in hist]
    bpsnr = [m["psnr"].float().mean().item() for m in hist]
    skipped = sum(int((~m["finite"]).sum().item()) for m in hist)
    samples = sum(int(m["n_samples"].sum().item()) for m in hist)
    t_total = sum(t for t, _, _ in blocks)
    rays = sum(s * b for _, s, b in blocks)
    step_s = sorted(t / s for t, s, _ in blocks)[len(blocks) // 2]
    finite = all(math.isfinite(v) for v in loss) and all(
        torch.isfinite(p).all().item() for p in model.param_list())
    print(f"train: Car L16F2 2^19 aabb_scale=4 bf16 use_fully fp16_grads "
          f"skip_nonfinite n_compact=64 lr=0.1 ema=0.95 synthetic "
          f"{TRAIN_VIEWS}x{TRAIN_SIZE}x{TRAIN_SIZE} steps={TRAIN_STEPS} "
          f"blocks={len(hist)} s_per_step_median={step_s:.4f} "
          f"train_rays_per_s={rays / t_total:.0f} "
          f"samples_per_s={samples / t_total:.0f} peak_mem_gib={peak_gib:.2f} "
          f"(held before: {held_gib:.2f}) "
          f"grid_update_s_median={sorted(grid_s)[len(grid_s) // 2]:.4f} "
          f"loss_first={loss[0]:.5f} loss_last={loss[-1]:.5f} "
          f"psnr_first={bpsnr[0]:.3f} psnr_last={bpsnr[-1]:.3f} "
          f"skipped={skipped} n_rays_per_batch={trainer.n_rays_per_batch} "
          f"launches " + " ".join(f"{k}={launches[k]}" for k in TRAIN_KERNELS)
          + f" [{card}]", flush=True)
    if not finite:
        fail("training produced a non-finite loss or parameter")
    if skipped > TRAIN_STEPS // 2:
        fail(f"{skipped} of {TRAIN_STEPS} steps were skipped as non-finite")
    if not bpsnr[-1] > bpsnr[0] + PSNR_RISE:
        fail(f"train PSNR rose from {bpsnr[0]:.3f} to {bpsnr[-1]:.3f}, "
             f"not by {PSNR_RISE} dB")
    if not all(launches[k] for k in TRAIN_KERNELS):
        fail(f"training did not run every kernel of its path: {launches}")

    # the stages of one step at the final batch size: CUDA events, medians
    batch = RayBatcher(data.n_images, data.n_pixels, trainer.n_rays_per_batch, seed=1)
    img_ids, pix_ids = batch.next()
    o, d = data.rays_for_pixels(img_ids, pix_ids)
    rays_o, rays_d = (torch.from_numpy(a).cuda() for a in (o, d))
    target = torch.from_numpy(data.pixel_values(img_ids, pix_ids)).cuda()
    bg = torch.ones_like(target)
    xi = torch.rand((rays_o.shape[0], 1), device="cuda", generator=gen)
    stages = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.enable_grad():
            loss_t, _ = trainer.forward(rays_o, rays_d, target, bg, xi)
            ev[1].record()
            grads = trainer.backward(loss_t)
        ev[2].record()
        trainer.update(grads)
        ev[3].record()
        ev[3].synchronize()
        for k, (a, b) in zip(stages, zip(ev, ev[1:])):
            stages[k].append(a.elapsed_time(b))
    med = {k: sorted(v)[len(v) // 2] for k, v in stages.items()}
    grid_ms = 1e3 * sorted(grid_s)[len(grid_s) // 2]
    print(f"train: step stages at {rays_o.shape[0]} rays, ms (median of 8): "
          + " ".join(f"{k}={v:.3f}" for k, v in med.items())
          + f" grid_update={grid_ms:.3f} (per {tcfg.update_den_freq} steps) "
          f"[{card}]", flush=True)

    # every parameter's gradient on one batch: the kernel path against the
    # plain path, and the encode kernels against the plain encode under the
    # same MLP kernels
    batch = (rays_o, rays_d, target, bg, xi)
    kern = train_gradients(trainer, batch, True, True)
    plain, _ = train_gradients(trainer, batch, False, False)
    split = encode_split(trainer, batch, kern)
    names = [f"table{i}" for i in range(len(model.tables))] + list(model.net.LAYERS)
    full = {n: rel(a, b) for n, a, b in zip(names, kern[0], plain)}
    ok = all(v <= (TABLE_E2E_REL_TOL if n.startswith("table") else GRAD_REL_TOL)
             for n, v in full.items())
    ok &= split_ok(split)
    print("train: gradient kernels vs plain path (encode and MLP), |a-b|/|b|: "
          + " ".join(f"{n}={v:.2e}" for n, v in full.items())
          + f" tol tables={TABLE_E2E_REL_TOL:.2e} mlp={GRAD_REL_TOL:.2e}; tables, "
          f"encode kernels vs plain encode under the MLP kernels: "
          + " ".join(f"table{i}={v:.2e}" for i, v in enumerate(split["tables"]))
          + f" tol {TABLE_GRAD_REL_TOL:.2e}; {split_fields(split)}", flush=True)
    if not ok:
        fail("kernel and plain path gradients disagree")

    return launches, (trainer, tcfg, data, gen)


def rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def train_gradients(trainer, batch, encode: bool, mlp: bool):
    """One batch's loss gradients (every parameter) through the encode
    kernels (or the plain encode) and the MLP kernels (or the plain MLP),
    and what the encode saw: its positions, its output and the output's
    gradient."""
    model = trainer.model
    seen = {}
    encode_fn = model.encode

    def recorded(positions):
        out = encode_fn(positions)
        seen.update(pos=positions.detach().reshape(-1, 3).contiguous(),
                    out=out.detach().reshape(-1, out.shape[-1]))
        out.register_hook(lambda g: seen.update(g=g.reshape(-1, g.shape[-1]).contiguous()))
        return out

    model.use_encode_kernel, model.net.use_fully = encode, mlp
    model.encode = recorded
    try:
        with torch.enable_grad():
            loss, _ = trainer.forward(*batch)
            grads = trainer.backward(loss)
    finally:
        del model.encode  # the class's method again
        model.use_encode_kernel = model.net.use_fully = True
    return grads, seen


def encode_split(trainer, batch, kernels=None) -> dict:
    """The encode kernels against the plain encode in one batch's gradients,
    both under the MLP kernels (``kernels``: train_gradients' result for the
    kernel path, when it was already taken): each table's gradient through
    the two (``tables``, |a-b|/|b|); the backward kernel alone against its
    plain version on the kernel path's positions and output gradient
    (``bwd``); and how many elements of the encode's output, and of its
    gradient, differ between the two paths bit for bit (``out_differ``,
    ``g_differ``; of ``n`` each; ``same_pos``: the march placed the same
    positions)."""
    from myc_nerfs_tpu_torch.ops import brick_grid as bg
    from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge

    model = trainer.model
    k_grads, k = kernels or train_gradients(trainer, batch, True, True)
    p_grads, p = train_gradients(trainer, batch, False, True)
    n_tables = len(model.tables)
    geo = (model.cfg.grid, model.levels, model.groups, model.compute_dtype)
    tables = [t.detach() for t in model.tables]
    with torch.no_grad():
        alone = ge.brick_encode_backward(tables, k["pos"], k["g"], *geo)
        ref = bg.paired_encode_backward_reference(tables, k["pos"], k["g"], *geo)
    return {"tables": [rel(a, b) for a, b in zip(k_grads[:n_tables], p_grads[:n_tables])],
            "bwd": [rel(a, b) for a, b in zip(alone, ref)],
            "out_differ": int((k["out"] != p["out"]).sum()),
            "g_differ": int((k["g"] != p["g"]).sum()),
            "n": k["out"].numel(), "same_pos": torch.equal(k["pos"], p["pos"])}


def split_ok(split: dict) -> bool:
    return all(v <= TABLE_GRAD_REL_TOL for v in split["tables"] + split["bwd"])


def split_fields(split: dict) -> str:
    return ("backward kernel alone vs plain on the kernel path's output gradient: "
            + " ".join(f"table{i}={v:.2e}" for i, v in enumerate(split["bwd"]))
            + f"; encode outputs differing bit for bit {split['out_differ']} of "
            f"{split['n']}, their gradients {split['g_differ']}, same positions "
            f"{split['same_pos']}")


def phase_split(card: str, train_ctx) -> None:
    """The train phase's encode split at many trained states: the same
    config trained again (seed 1) through run_net.train_loop, checked after
    each of its 16 blocks on SPLIT_BATCHES fresh batches. Fails, after every
    state is printed, where a table breaches TABLE_GRAD_REL_TOL."""
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.data.blender import RayBatcher

    _, _, data, _ = train_ctx
    cfg = load_config("configs/ngp/Car.py")
    cfg.update(synthetic=True, synthetic_views=TRAIN_VIEWS, synthetic_size=TRAIN_SIZE)
    gen = torch.Generator(device="cuda").manual_seed(1)
    xi_gen = torch.Generator(device="cuda").manual_seed(2)
    trainer, tcfg = run_net.build_trainer(cfg, gen, device="cuda")
    train_block, results = trainer.train_block, []

    def checked_block(*a, **k):
        m = train_block(*a, **k)
        for b in range(SPLIT_BATCHES):
            seed = 1000 * len(results) + b
            img_ids, pix_ids = RayBatcher(data.n_images, data.n_pixels,
                                          trainer.n_rays_per_batch, seed=seed).next()
            rays_o, rays_d = (torch.from_numpy(x).cuda()
                              for x in data.rays_for_pixels(img_ids, pix_ids))
            target = torch.from_numpy(data.pixel_values(img_ids, pix_ids)).cuda()
            xi = torch.rand((rays_o.shape[0], 1), device="cuda", generator=xi_gen)
            split = encode_split(trainer, (rays_o, rays_d, target,
                                           torch.ones_like(target), xi))
            results.append(split)
            print(f"split: step {trainer.state.step} batch {b} rays {rays_o.shape[0]}: "
                  f"tables, encode kernels vs plain encode: "
                  + " ".join(f"{v:.2e}" for v in split["tables"])
                  + "; " + split_fields(split), flush=True)
        return m

    trainer.train_block = checked_block
    run_net.train_loop(trainer, tcfg, data, TRAIN_STEPS, gen, log=lambda msg: None)
    bad = [i for i, s in enumerate(results) if not split_ok(s)]
    print(f"split: {len(results)} checks at {len(results) // SPLIT_BATCHES} trained states; "
          f"tables max {max(max(s['tables']) for s in results):.2e}, backward alone max "
          f"{max(max(s['bwd']) for s in results):.2e} (tol {TABLE_GRAD_REL_TOL:.2e}); "
          f"checks with encode outputs differing "
          f"{sum(s['out_differ'] > 0 for s in results)}, breaching {len(bad)} [{card}]",
          flush=True)
    if bad:
        fail(f"encode kernels vs plain encode breach {TABLE_GRAD_REL_TOL} at checks {bad}")


def planted_backward(x, weights, g, need_dx=True, fault=None, sums=None):
    """fused_mlp_backward_reference (fault None: the same steps and bits)
    with a fault planted, as a faulty kernel would compute it: 'no_lo'
    forms dW from the gradient rounded to x's dtype (the kernel's lo term
    dropped), 'unrounded_g' feeds the unrounded f32 gradient to the dgrad
    product. ``sums`` collects, per layer, the largest sum of |post| |g|
    over one dW element (below 2^24, integer inputs sum exactly)."""
    acc = torch.float32
    post = [x]
    for w in weights[:-1]:
        post.append(torch.relu(post[-1].to(acc) @ w.to(acc)).to(x.dtype))
    g = g.to(x.dtype).to(acc)
    dws = [None] * len(weights)
    for i in range(len(weights) - 1, -1, -1):
        g_dw = g.to(x.dtype).to(acc) if fault == "no_lo" else g
        dws[i] = (post[i].to(acc).T @ g_dw).to(weights[i].dtype)
        if sums is not None:
            sums.append((post[i].double().T @ g.double().abs()).max().item())
        if i == 0 and not need_dx:
            return None, dws
        g = (g if fault == "unrounded_g" else g.to(x.dtype).to(acc)) @ weights[i].to(acc).T
        if i > 0:
            g = g * (post[i].to(acc) > 0.0)
    return g.to(x.dtype), dws


def exact_magnitudes(x, weights, g):
    """The largest |post_i| and |g_i| (g_i the gradient at layer i's output)
    of a backward on integer inputs: the operands of its 3xTF32 dW."""
    post = [x.double()]
    for w in weights[:-1]:
        post.append(torch.relu(post[-1] @ w.double()))
    g = g.double()
    big_g = g.abs().max().item()
    for i in range(len(weights) - 1, 0, -1):
        g = (g @ weights[i].double().T) * (post[i] > 0)
        big_g = max(big_g, g.abs().max().item())
    return max(p.abs().max().item() for p in post), big_g


def differing(a, b) -> int:
    return int((a != b).sum().item())


def phase_kernel_wide(fm) -> tuple:
    """The wide fused-MLP kernels at OriginNeRF's chain (phase 11)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    padded = fm.padded_widths(WIDE_CHAIN)
    shape = (f"{'x'.join(map(str, WIDE_CHAIN))} (padded {'x'.join(map(str, padded))}) "
             f"rows={WIDE_ROWS} tf32=off")
    fwd, bwd = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand((WIDE_ROWS, WIDE_CHAIN[0]), device="cuda", generator=g).to(dtype)
        ws = [(torch.randn((a, b), device="cuda", generator=g) / a ** 0.5).to(dtype)
              for a, b in zip(WIDE_CHAIN[:-1], WIDE_CHAIN[1:])]
        xp, wsp, _ = fm.pad_chain(x, ws)
        with torch.no_grad():
            y = fm.fused_mlp(x, ws)
            ref = fm.fused_mlp_reference(x, ws)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            tol = TOL[dtype](ref.float().abs().max().item())
            t_k = graph_ms(lambda: fm.fused_mlp(x, ws))
            t_c = median_ms(lambda: fm.fused_mlp(x, ws))
            t_p = graph_ms(lambda: fm.fused_mlp_reference(x, ws))
            # cuBLAS on 257-wide rows (514 bytes in bf16, not 16-byte
            # aligned) and on the padded, aligned chain
            t_l = graph_ms(lambda: library_chain(x, ws))
            t_lp = graph_ms(lambda: library_chain(xp, wsp))
        work = fm.mlp_work(WIDE_CHAIN, WIDE_ROWS, dtype)
        ok = err <= tol and y.shape == ref.shape
        fwd_faults = {}
        if dtype == torch.float32:  # what the same check reads of each planted fault
            with torch.no_grad():
                for fault in F32_FAULTS:
                    fwd_faults[fault] = (fm.forward_3xtf32(x, ws, fault)
                                         - ref).abs().max().item()
        print(f"kernel_wide: fused_mlp_wide {shape} {dtype_name(dtype)} "
              f"max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'BREACH'} "
              f"{bound_fields(t_k, work)} call_ms={t_c:.4f} plain_ms={t_p:.4f} "
              f"library_ms={min(t_l, t_lp):.4f} (cuBLAS chain 257 wide {t_l:.4f}, "
              f"padded to 272 {t_lp:.4f})", flush=True)
        for fault, e in fwd_faults.items():
            print(f"kernel_wide: planted f32 fault {fault} (the plain forward with it): "
                  f"max_abs_err={e:.3e} against tol {tol:.3e}: the random-input check "
                  f"{'sees' if e > tol else 'DOES NOT SEE'} it", flush=True)
        if not ok:
            fail(f"fused_mlp_wide {dtype}: max abs err {err} > {tol}")
        if any(e <= tol for e in fwd_faults.values()):
            fail(f"fused_mlp_wide f32: a planted fault reads within the limit: {fwd_faults}")
        if dtype == torch.bfloat16:  # the flagship's dtype
            fwd = {"max_abs_err": err, "ms": t_k, "call_ms": t_c, "plain_ms": t_p,
                   "library_ms": min(t_l, t_lp), "library_unpadded_ms": t_l,
                   "library_padded_ms": t_lp, "bound_ms": work["bound_ms"],
                   "bound_by": work["bound_by"]}

        # backward, exact inputs: the same bits, and each planted fault seen
        xe, wse, ge_ = fm.exact_inputs(WIDE_CHAIN, WIDE_EXACT_ROWS, dtype, "cuda", seed=5)
        dx, dws = fm.fused_mlp_backward(xe, wse, ge_)
        dx_ref, dws_ref = fm.fused_mlp_backward_reference(xe, wse, ge_)
        sums = []
        dx_pl, dws_pl = planted_backward(xe, wse, ge_, sums=sums)
        torch.cuda.synchronize()
        exact_diff = [differing(dx, dx_ref)] + [differing(a, b) for a, b in zip(dws, dws_ref)]
        exact_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip([dx] + dws, [dx_ref] + dws_ref))
        plain_same = torch.equal(dx_pl, dx_ref) and all(map(torch.equal, dws_pl, dws_ref))
        ok_exact = not any(exact_diff) and max(sums) < EXACT_LIMIT and plain_same
        if dtype == torch.float32:  # the 3xTF32 dW's operands against its exact limits
            big_post, big_g = exact_magnitudes(xe, wse, ge_)
            lo, hi = (2.0 ** b for b in TF32_EXACT_BITS)
            within = min(big_post, big_g) < lo and max(big_post, big_g) < hi
            print(f"kernel_wide_bwd: f32 exact inputs ({WIDE_EXACT_ROWS} rows): largest "
                  f"|post| {big_post:.0f}, |g| {big_g:.0f}; 3xTF32 exact on every dW "
                  f"product (one operand < 2^{TF32_EXACT_BITS[0]}, the other < "
                  f"2^{TF32_EXACT_BITS[1]}): {within}", flush=True)
        seen = {}
        if dtype == torch.bfloat16:
            for fault in FAULTS:
                fdx, fdws = planted_backward(xe, wse, ge_, fault=fault)
                seen[fault] = (differing(fdx, dx_ref),
                               sum(differing(a, b) for a, b in zip(fdws, dws_ref)))
        # random inputs: the norm of the error, and the same bits again
        gy = torch.randn((WIDE_ROWS, WIDE_CHAIN[-1]), device="cuda", generator=g).to(dtype)
        dx, dws = fm.fused_mlp_backward(x, ws, gy)
        dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, gy)
        dx2, dws2 = fm.fused_mlp_backward(x, ws, gy)
        torch.cuda.synchronize()
        same = torch.equal(dx, dx2) and all(map(torch.equal, dws, dws2))
        norm_errs = [rel(a, b) for a, b in zip([dx] + dws, [dx_ref] + dws_ref)]
        max_errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip([dx] + dws, [dx_ref] + dws_ref)]
        planted = {}
        for fault in seen:
            fdx, fdws = planted_backward(x, ws, gy, fault=fault)
            planted[fault] = (rel(fdx, dx_ref), max(rel(a, b) for a, b in zip(fdws, dws_ref)))
        del dx2, dws2
        f32_seen = {}
        if dtype == torch.float32:
            tol_dx, tol_dw = BWD_TOL[dtype]

            def within(errs):
                return [e <= (tol_dx if i == 0 else tol_dw) * max(1.0, b.abs().max().item())
                        for i, (e, b) in enumerate(zip(errs, [dx_ref] + dws_ref))]

            ok_rand = all(within(max_errs))
            rand_tol = f"max_abs dx {tol_dx:g} dW {tol_dw:g} of scale"
            for fault in F32_FAULTS:  # what the same check reads of each planted fault
                fdx, fdws = fm.backward_3xtf32(x, ws, gy, fault=fault)
                f_errs = [(a - b).abs().max().item()
                          for a, b in zip([fdx] + fdws, [dx_ref] + dws_ref)]
                f32_seen[fault] = (f_errs[0], max(f_errs[1:]), not all(within(f_errs)))
                del fdx, fdws
        else:
            ok_rand = max(norm_errs) <= WIDE_BWD_NORM_TOL
            rand_tol = f"norm {WIDE_BWD_NORM_TOL:g}"
        xl = x.clone().requires_grad_()
        wl = [w.clone().requires_grad_() for w in ws]
        xpl = xp.clone().requires_grad_()
        wpl = [w.clone().requires_grad_() for w in wsp]
        gyp = torch.nn.functional.pad(gy, (0, padded[-1] - WIDE_CHAIN[-1]))
        b_k = graph_ms(lambda: fm.fused_mlp_backward(x, ws, gy))
        b_c = median_ms(lambda: fm.fused_mlp_backward(x, ws, gy))
        b_p = graph_ms(lambda: fm.fused_mlp_backward_reference(x, ws, gy))
        b_l = graph_ms(lambda: torch.autograd.grad(library_chain(xl, wl), [xl] + wl, gy))
        b_lp = graph_ms(lambda: torch.autograd.grad(library_chain(xpl, wpl), [xpl] + wpl, gyp))
        b_work = fm.mlp_work(WIDE_CHAIN, WIDE_ROWS, dtype, backward=True)
        unseen = [f for f, counts in seen.items() if not any(counts)]
        unseen += [f for f, (_, _, caught) in f32_seen.items() if not caught]
        ok = ok_exact and ok_rand and same and not unseen
        print(f"kernel_wide_bwd: fused_mlp_wide_backward {shape} {dtype_name(dtype)} "
              f"exact inputs ({WIDE_EXACT_ROWS} rows, largest sum of magnitudes "
              f"{max(sums):.3e} < 2^24, plain steps equal={plain_same}): elements differing "
              f"dx={exact_diff[0]} dW={sum(exact_diff[1:])} (tol 0); random inputs "
              f"|a-b|/|b| dx={norm_errs[0]:.2e} dW max={max(norm_errs[1:]):.2e} max_abs "
              f"dx={max_errs[0]:.3e} dW={max(max_errs[1:]):.3e} (tol {rand_tol}) "
              f"deterministic={same} {'ok' if ok else 'BREACH'} {bound_fields(b_k, b_work)} "
              f"call_ms={b_c:.4f} plain_ms={b_p:.4f} library_ms={min(b_l, b_lp):.4f} "
              f"(cuBLAS chain + autograd.grad 257 wide {b_l:.4f}, padded to 272 "
              f"{b_lp:.4f})", flush=True)
        for fault in seen:
            print(f"kernel_wide_bwd: planted fault {fault} (the plain backward with it): "
                  f"exact inputs, elements differing from the reference dx={seen[fault][0]} "
                  f"dW={seen[fault][1]} (the exact check sees it if either is above 0); "
                  f"random inputs |a-b|/|b| dx={planted[fault][0]:.2e} "
                  f"dW max={planted[fault][1]:.2e} against tol {WIDE_BWD_NORM_TOL:g}",
                  flush=True)
        for fault, (e_dx, e_dw, caught) in f32_seen.items():
            print(f"kernel_wide_bwd: planted f32 fault {fault} (the plain backward with it in "
                  f"dW): random inputs max_abs dx={e_dx:.3e} dW={e_dw:.3e} (tol {rand_tol}): "
                  f"the random-input check {'sees' if caught else 'DOES NOT SEE'} it",
                  flush=True)
        if not ok:
            fail(f"fused_mlp_wide_backward {dtype}: exact {exact_diff} (sums {max(sums)}, "
                 f"plain steps equal {plain_same}) random {norm_errs} deterministic {same} "
                 f"planted faults no check sees {unseen}")
        wide_non_finite(fm, x, ws, gy, dtype)
        if dtype == torch.float32:
            wide_dw_error_by_rows(fm)
        if dtype == torch.bfloat16:
            bwd = {"max_abs_err": exact_err, "max_abs_err_random": max(max_errs),
                   "norm_err_random": max(norm_errs), "ms": b_k, "call_ms": b_c,
                   "plain_ms": b_p, "library_ms": min(b_l, b_lp), "library_unpadded_ms": b_l,
                   "library_padded_ms": b_lp, "bound_ms": b_work["bound_ms"],
                   "bound_by": b_work["bound_by"]}
    return fwd, bwd


def wide_dw_error_by_rows(fm) -> None:
    """Phase 11's f32 check at more row counts, up to twice WIDE_ROWS (the
    f32 quality run's 8192 rays x 32 samples): random inputs drawn as the
    f32 check draws them, each backward's dx and largest dW error (max_abs
    over the reference's scale) against BWD_TOL. The rows of a dW row split
    grow with the call's rows; the tensor cores round the accumulator toward
    zero, so an error that grew with them would show here."""
    tol_dx, tol_dw = BWD_TOL[torch.float32]
    g = torch.Generator(device="cuda").manual_seed(7)
    padded = fm.padded_widths(WIDE_CHAIN)
    readings, ok = [], True
    for rows in DW_ERR_ROWS:
        x = torch.rand((rows, WIDE_CHAIN[0]), device="cuda", generator=g)
        ws = [torch.randn((a, b), device="cuda", generator=g) / a ** 0.5
              for a, b in zip(WIDE_CHAIN[:-1], WIDE_CHAIN[1:])]
        gy = torch.randn((rows, WIDE_CHAIN[-1]), device="cuda", generator=g)
        dx, dws = fm.fused_mlp_backward(x, ws, gy)
        dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, gy)
        errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip([dx] + dws, [dx_ref] + dws_ref)]
        plan = fm.wide_plan(padded, rows, torch.float32, torch.cuda.get_device_properties(
            0).multi_processor_count)
        ok = ok and errs[0] <= tol_dx and max(errs[1:]) <= tol_dw
        readings.append(f"{rows} rows ({plan.dw_splits} splits of {plan.dw_split_rows}) "
                        f"dx {errs[0]:.2e} dW {max(errs[1:]):.2e}")
        del x, ws, gy, dx, dws, dx_ref, dws_ref
    print(f"kernel_wide_bwd: f32 error against rows, max_abs over scale (tol dx {tol_dx:g} "
          f"dW {tol_dw:g}): {'; '.join(readings)} {'ok' if ok else 'BREACH'}", flush=True)
    if not ok:
        fail(f"fused_mlp_wide_backward f32: error beyond the limit at some rows: {readings}")


def wide_non_finite(fm, x, ws, gy, dtype) -> None:
    """Phase 11's non-finite check: a NaN, an inf and a NaN whose payload
    lies in the low 13 bits alone (cleared, as a TF32 read clears them, it
    would read inf) planted in x (rows NONFINITE_ROWS) come out of the wide
    kernels where the plain versions put them. Forward: the same NaN and
    the same inf elements. Backward: the same non-finite elements of dx and
    every dW. An inf may read NaN there: the kernels form dW from two or
    three products (bf16: the gradient's head and rest; f32: 3xTF32), and
    inf times a rest of 0, or of the head's opposite sign, is NaN where the
    plain version's one product is inf."""
    rows = NONFINITE_ROWS
    xb = x[:rows[-1] + 64].clone()
    xb[rows[0], 3] = float("nan")
    xb[rows[1], 10] = float("inf")
    if dtype == torch.float32:  # a NaN that reads inf once its low 13 bits are cleared
        xb.view(torch.int32)[rows[2], 7] = 0x7F800001
    else:
        xb.view(torch.int16)[rows[2], 7] = 0x7F81
    g = gy[:xb.shape[0]]
    with torch.no_grad():
        y, ref = fm.fused_mlp(xb, ws), fm.fused_mlp_reference(xb, ws)
    dx, dws = fm.fused_mlp_backward(xb, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(xb, ws, g)
    torch.cuda.synchronize()
    fwd_same = (torch.equal(torch.isnan(y), torch.isnan(ref))
                and torch.equal(torch.isinf(y), torch.isinf(ref)))
    bwd_same = [torch.equal(torch.isfinite(a), torch.isfinite(b))
                for a, b in zip([dx] + dws, [dx_ref] + dws_ref)]
    planted = bool((~torch.isfinite(y[list(rows)])).any(1).all())
    print(f"kernel_wide_nonfinite: {dtype_name(dtype)} NaN at x[{rows[0]}, 3], inf at "
          f"x[{rows[1]}, 10], a low-payload NaN at x[{rows[2]}, 7] of {xb.shape[0]} rows: "
          f"forward NaN {int(torch.isnan(y).sum())} "
          f"(plain {int(torch.isnan(ref).sum())}) inf {int(torch.isinf(y).sum())} "
          f"(plain {int(torch.isinf(ref).sum())}) same elements={fwd_same}; backward "
          f"non-finite dx {int((~torch.isfinite(dx)).sum())} (plain "
          f"{int((~torch.isfinite(dx_ref)).sum())}) dW "
          f"{sum(int((~torch.isfinite(a)).sum()) for a in dws)} (plain "
          f"{sum(int((~torch.isfinite(b)).sum()) for b in dws_ref)}) same elements="
          f"{all(bwd_same)} {'ok' if fwd_same and all(bwd_same) and planted else 'BREACH'}",
          flush=True)
    if not (fwd_same and all(bwd_same) and planted):
        fail(f"fused_mlp_wide {dtype}: non-finite values not where the plain version puts "
             f"them (forward {fwd_same}, backward {bwd_same}, planted rows non-finite {planted})")


def block_psnr(hist):
    return [m["psnr"].float().mean().item() for m in hist]


def nerf_config():
    """configs/nerf/budget_synthetic.py with the scene cut to NERF_VIEWS
    views at NERF_SIZE^2 (and its 3 held-out views)."""
    from myc_nerfs_tpu_torch.core.config import load_config

    cfg = load_config("configs/nerf/budget_synthetic.py")
    cfg.update(synthetic_views=NERF_VIEWS, synthetic_size=NERF_SIZE)
    return cfg


def phase_nerf_train(card: str):
    """Phase 12: OriginNeRF through run_net, and its checkpoint."""
    import tempfile

    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.checkpoint import restore_checkpoint
    from myc_nerfs_tpu_torch.models.ori_nerf import OriginNeRFModel

    cfg = nerf_config()
    data, h, w = run_net.load_data(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer, tcfg = run_net.build_trainer(cfg, gen, device="cuda")
    model = trainer.model
    if not (isinstance(model, OriginNeRFModel) and model.cfg.skips == (4,)
            and model.cfg.D == 8 and model.cfg.W == 256 and model.cfg.use_bf16
            and not model.cfg.use_fused and tcfg.lr == 1e-3 and trainer.rcfg.n_coarse == 128
            and trainer.rcfg.n_compact == 32 and tcfg.n_rays_per_batch == 4096):
        fail(f"budget_synthetic did not build as expected: {model.cfg} {tcfg} {trainer.rcfg}")
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        hist = run_net.train_loop(trainer, tcfg, data, NERF_STEPS, gen, cfg=cfg, out_dir=out,
                                  H=h, W=w, log=lambda msg: None)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = read_launches()
        ckpt = f"{out}/model.ckpt"
        size_mb = Path(ckpt).stat().st_size / 2**20
        fresh, _ = run_net.build_trainer(cfg, torch.Generator(device="cuda").manual_seed(9),
                                         device="cuda")
        t0 = time.perf_counter()
        fresh.state, meta = restore_checkpoint(ckpt, fresh.state)
        t_restore = time.perf_counter() - t0
    a, b = fresh.state, trainer.state
    same = (a.step == b.step == meta["step"] == NERF_STEPS
            and all(torch.equal(x, y) and x.dtype == y.dtype
                    for x, y in zip(fresh.model.param_list(), model.param_list()))
            and torch.equal(a.opt_state.count, b.opt_state.count)
            and all(torch.equal(x, y) for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                                                      b.opt_state.mu + b.opt_state.nu))
            and all(torch.equal(x, y) for x, y in zip(a.occ, b.occ)))
    bpsnr = block_psnr(hist)
    skipped = sum(int((~m["finite"]).sum().item()) for m in hist)
    finite = all(torch.isfinite(p).all().item() for p in model.param_list())
    print(f"nerf_train: budget_synthetic OriginNeRF D=8 W=256 skips=(4,) bf16 lr=1e-3 "
          f"n_coarse=128 n_compact=32 detail {NERF_VIEWS}x{NERF_SIZE}x{NERF_SIZE} "
          f"steps={NERF_STEPS} s={t_train:.2f} psnr_first={bpsnr[0]:.3f} "
          f"psnr_last={bpsnr[-1]:.3f} skipped={skipped} "
          f"n_rays_per_batch={trainer.n_rays_per_batch} checkpoint {size_mb:.1f} MiB "
          f"restored in {t_restore:.2f} s bit_for_bit={same} launches "
          + " ".join(f"{k}={v}" for k, v in launches.items() if v) + f" [{card}]", flush=True)
    if not finite:
        fail("OriginNeRF training produced a non-finite parameter")
    if not bpsnr[-1] > bpsnr[0] + NERF_PSNR_RISE:
        fail(f"OriginNeRF train PSNR rose from {bpsnr[0]:.3f} to {bpsnr[-1]:.3f}")
    if not same:
        fail("the restored OriginNeRF trainer differs from the saved one")
    return launches, (cfg, data)


def flagship_gradients(model, trainer, data, gen, planted: dict):
    """Every parameter's gradient of a flagship through the kernels against
    the gradient through the plain versions (the model's mlp seam:
    fused_mlp_plain) on FLAGSHIP_GRAD_SEEDS batches, |a-b|/|b| per
    parameter; and of each planted backward (a plain backward with a fault)
    on the first batch. Returns (max per parameter, max per batch, max per
    planted fault)."""
    from myc_nerfs_tpu_torch.data.blender import RayBatcher
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    def gradients(batch, mlp):
        model.mlp = mlp
        try:
            with torch.enable_grad():
                loss, _ = trainer.forward(*batch)
                return trainer.backward(loss)
        finally:
            model.mlp = fm.fused_mlp

    def errors(a, b):
        return {f"{layer}/{kind}": rel(x, y) for (layer, kind), x, y in
                zip(model.leaf_names(), a, b)}

    readings, faults = [], {}
    for seed in range(FLAGSHIP_GRAD_SEEDS):
        img_ids, pix_ids = RayBatcher(data.n_images, data.n_pixels, 4096, seed=7 + seed).next()
        rays_o, rays_d = (torch.from_numpy(a).cuda()
                          for a in data.rays_for_pixels(img_ids, pix_ids))
        target = torch.from_numpy(data.pixel_values(img_ids, pix_ids)).cuda()
        xi = torch.rand((rays_o.shape[0], 1), device="cuda", generator=gen)
        batch = (rays_o, rays_d, target, torch.ones_like(target), xi)
        plain = gradients(batch, fm.fused_mlp_plain)
        readings.append(errors(gradients(batch, fm.fused_mlp), plain))
        if seed == 0:
            for name, backward in planted.items():
                faulty = partial(fm.fused_mlp_plain, backward=backward)
                faults[name] = max(errors(gradients(batch, faulty), plain).values())
    errs = {k: max(r[k] for r in readings) for k in readings[0]}
    return errs, [max(r.values()) for r in readings], faults


def phase_flagship_fused(card: str, nerf_ctx):
    """Phase 13: the fused flagship through NGPTrainer(model=)."""
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.models import ori_nerf
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainer
    from myc_nerfs_tpu_torch.utils.metrics import psnr

    cfg, data = nerf_ctx
    gen = torch.Generator(device="cuda").manual_seed(3)
    base, tcfg = run_net.build_trainer(cfg, gen, device="cuda")
    model = ori_nerf.OriginNeRFModel(ori_nerf.OriginNeRFConfig(skips=(), use_bf16=True,
                                                               use_fused=True),
                                     device="cuda", generator=gen)
    trainer = NGPTrainer(None, base.rcfg, tcfg, gen, device="cuda", model=model)
    reset_launches()
    t0 = time.perf_counter()
    hist = run_net.train_loop(trainer, tcfg, data, FLAGSHIP_STEPS, gen, log=lambda msg: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_launches()
    bpsnr = block_psnr(hist)
    finite = all(torch.isfinite(p).all().item() for p in model.param_list())

    # every parameter's gradient through the kernels and through the plain
    # versions (the model's mlp seam) on FLAGSHIP_GRAD_SEEDS batches, and
    # through the planted faults of phase 11 on the first
    errs, per_seed, faults = flagship_gradients(
        model, trainer, data, gen, {f: partial(planted_backward, fault=f) for f in FAULTS})
    grad_ok = max(per_seed) <= FLAGSHIP_GRAD_TOL

    # the same in f32 (the f32 kernels) on an f32 model holding the trained
    # bf16 flagship's weights and occupancy grid: no further steps
    g32 = torch.Generator(device="cuda").manual_seed(5)
    model32 = ori_nerf.OriginNeRFModel(ori_nerf.OriginNeRFConfig(skips=(), use_bf16=False,
                                                                 use_fused=True),
                                       device="cuda", generator=g32)
    with torch.no_grad():
        for p32, p in zip(model32.param_list(), model.param_list()):
            p32.copy_(p.float())
    trainer32 = NGPTrainer(None, base.rcfg, tcfg, g32, device="cuda", model=model32)
    trainer32.state = trainer32.state._replace(occ=trainer.state.occ)
    errs32, per_seed32, faults32 = flagship_gradients(
        model32, trainer32, data, g32,
        {f: partial(fm.backward_3xtf32, fault=f) for f in F32_FAULTS})
    grad32_ok = max(per_seed32) <= FLAGSHIP_F32_GRAD_TOL
    del model32, trainer32

    # one held-out view through the fused path
    imgs, c2ws, intrs = run_net.load_eval_views(cfg)
    before = counters()["fused_mlp_wide"].launches
    rgb, _ = trainer.render_image(c2ws[0], intrs[0], NERF_SIZE, NERF_SIZE)
    torch.cuda.synchronize()
    val_launches = counters()["fused_mlp_wide"].launches - before
    val = float(psnr(torch.clamp(rgb, 0, 1).cpu(), torch.from_numpy(imgs[0])))
    render_ok = bool(torch.isfinite(rgb).all()) and val_launches > 0
    worst = max(errs, key=errs.get)
    print(f"flagship_fused: OriginNeRF D=8 W=256 skips=() bf16 use_fused lr=1e-3 "
          f"detail {NERF_VIEWS}x{NERF_SIZE}x{NERF_SIZE} steps={FLAGSHIP_STEPS} "
          f"s={t_train:.2f} psnr_first={bpsnr[0]:.3f} psnr_last={bpsnr[-1]:.3f} "
          f"launches fused_mlp_wide={launches['fused_mlp_wide']} "
          f"fused_mlp_wide_bwd={launches['fused_mlp_wide_bwd']}; gradient kernels vs plain "
          f"versions |a-b|/|b| on {FLAGSHIP_GRAD_SEEDS} batches: max per batch "
          + " ".join(f"{v:.2e}" for v in per_seed)
          + f"; max {errs[worst]:.2e} ({worst}), per parameter "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" tol {FLAGSHIP_GRAD_TOL:.2e}; planted faults (first batch, max) "
          + " ".join(f"{k}={v:.2e}" for k, v in faults.items())
          + f"; val view {NERF_SIZE}x{NERF_SIZE} psnr={val:.3f} "
          f"render_launches fused_mlp_wide={val_launches} [{card}]", flush=True)
    worst32 = max(errs32, key=errs32.get)
    print(f"flagship_fused: f32 OriginNeRF D=8 W=256 skips=() use_fused, the trained bf16 "
          f"weights: gradient kernels vs plain versions |a-b|/|b| on {FLAGSHIP_GRAD_SEEDS} "
          f"batches: max per batch " + " ".join(f"{v:.2e}" for v in per_seed32)
          + f"; max {errs32[worst32]:.2e} ({worst32}) tol {FLAGSHIP_F32_GRAD_TOL:.2e}; planted "
          f"f32 faults (first batch, max) "
          + " ".join(f"{k}={v:.2e} ({'seen' if v > FLAGSHIP_F32_GRAD_TOL else 'not seen'})"
                     for k, v in faults32.items()) + f" [{card}]", flush=True)
    if not (launches["fused_mlp_wide"] and launches["fused_mlp_wide_bwd"]):
        fail(f"the fused flagship did not run the wide kernels: {launches}")
    if not finite:
        fail("the fused flagship produced a non-finite parameter")
    if not bpsnr[-1] > bpsnr[0] + FLAGSHIP_PSNR_RISE:
        fail(f"fused flagship train PSNR rose from {bpsnr[0]:.3f} to {bpsnr[-1]:.3f}")
    if not grad_ok:
        fail(f"fused flagship gradients disagree with the plain versions: {errs}")
    if not grad32_ok:
        fail(f"f32 fused flagship gradients disagree with the plain versions: {errs32}")
    if not render_ok:
        fail("the fused flagship's val render is not finite or ran no wide kernel")
    launches["fused_mlp_wide"] += val_launches
    return launches, (trainer, tcfg, data, gen)


def phase_hash_march(card: str):
    """Phase 14: the non-fused march (F3's path) in training."""
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.models import ngp
    from myc_nerfs_tpu_torch.render.ngp_render import NGPRenderConfig
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainConfig, NGPTrainer

    cfg = {"synthetic": True, "synthetic_views": TRAIN_VIEWS, "synthetic_size": TRAIN_SIZE}
    data, _, _ = run_net.load_data(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    trainer = NGPTrainer(
        ngp.NGPModelConfig(use_bf16=True, grid_impl="hash"),
        NGPRenderConfig(n_coarse=128, n_samples=64, n_compact=20, near_distance=0.05,
                        fused_march=False, compact_source="network"),
        NGPTrainConfig(lr=1e-2, n_rays_per_batch=4096), gen, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    hist = run_net.train_loop(trainer, trainer.cfg, data, HASH_STEPS, gen, log=lambda m: None)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_launches()
    bpsnr = block_psnr(hist)
    print(f"hash_march: NGP grid_impl=hash fused_march=False compact_source=network bf16 "
          f"blobs {TRAIN_VIEWS}x{TRAIN_SIZE}x{TRAIN_SIZE} steps={HASH_STEPS} s={t_train:.2f} "
          f"psnr_first={bpsnr[0]:.3f} psnr_last={bpsnr[-1]:.3f} samples_last="
          f"{int(hist[-1]['n_samples'][-1])} launches "
          + " ".join(f"{k}={v}" for k, v in launches.items() if v) + f" [{card}]", flush=True)
    if not (launches["fused_mlp"] and launches["fused_mlp_bwd"]):
        fail(f"hash_march did not run the fused-MLP kernels: {launches}")
    if not bpsnr[-1] > bpsnr[0] + HASH_PSNR_RISE:
        fail(f"hash_march train PSNR rose from {bpsnr[0]:.3f} to {bpsnr[-1]:.3f}")
    return launches


def wide_backward_split(card: str) -> None:
    """Phase 9's split of the wide fused-MLP backward at WIDE_CHAIN and
    WIDE_ROWS by kernel, bf16 and f32."""
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand((WIDE_ROWS, WIDE_CHAIN[0]), device="cuda", generator=g).to(torch.bfloat16)
    ws = [(torch.randn((a, b), device="cuda", generator=g) / a ** 0.5).to(torch.bfloat16)
          for a, b in zip(WIDE_CHAIN[:-1], WIDE_CHAIN[1:])]
    gy = torch.randn((WIDE_ROWS, WIDE_CHAIN[-1]), device="cuda", generator=g).to(torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        x, gy, ws = x.to(dtype), gy.to(dtype), [w.to(dtype) for w in ws]
        fm.fused_mlp_backward(x, ws, gy)
        prof = profiling.device_profile(lambda: fm.fused_mlp_backward(x, ws, gy))
        print_profile(f"profile: fused_mlp_wide_backward {dtype_name(dtype)} {WIDE_ROWS} rows, "
                      "by kernel", prof, card)


def phase_profile(card: str, train_ctx, flagship_ctx) -> None:
    """Where the time goes, after every counted and timed run: one render
    chunk stage by stage, one 800x800 frame (the slice's model, built
    again) and one train block of update_den_freq steps at 4096 rays
    (the trained model) under torch.profiler, each also timed without it,
    for the device's busy share of the wall time; then the wide fused-MLP
    backward at WIDE_CHAIN and WIDE_ROWS in bf16 by kernel, and one train
    block of the fused flagship (phase 13's trainer)."""
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.data.blender import RayBatcher
    from myc_nerfs_tpu_torch.geom.camera_path import path_spherical

    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer, _ = run_net.build_trainer(load_config("configs/ngp/Car.py"), gen, device="cuda")
    for _ in range(16):
        trainer.state = trainer.state._replace(occ=trainer.grid_update(trainer.state.occ, gen))
    intr = torch.tensor([[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1.0]])
    pose = run_net.path_pose(path_spherical(FRAMES)[1])
    bg = torch.tensor(trainer.cfg.background_color, device="cuda")
    split = profiling.render_chunk_split(trainer, *chunk_rays(pose), bg)
    print("profile: render chunk of 4096 rays, ms by stage (CUDA events, median of 20; "
          "mlp_device: device time alone): "
          + " ".join(f"{k}={v:.4f}" for k, v in split.items()) + f" [{card}]", flush=True)
    wall_ms = profiling.wall_ms(lambda: trainer.render_image(pose, intr, H, W))
    prof = profiling.device_profile(lambda: trainer.render_image(pose, intr, H, W))
    print_profile("profile: one 800x800 frame", prof, card, wall_ms=wall_ms)

    trainer, tcfg, data, gen = train_ctx
    S, n_rays = tcfg.update_den_freq, 4096
    batch = RayBatcher(data.n_images, data.n_pixels, n_rays, seed=2)
    ids = [batch.next() for _ in range(S)]
    rays = [data.rays_for_pixels(*i) for i in ids]
    block = (np.stack([o for o, _ in rays]), np.stack([d for _, d in rays]),
             np.stack([data.pixel_values(*i) for i in ids]))
    metrics = trainer.train_block(*block, generator=gen)
    samples = metrics["n_samples"].float().mean().item()
    wall_ms = profiling.wall_ms(lambda: trainer.train_block(*block, generator=gen))
    prof = profiling.device_profile(lambda: trainer.train_block(*block, generator=gen))
    print_profile(f"profile: one train block of {S} steps at {n_rays} rays "
                  f"({samples:.0f} samples per step), per step", prof, card, per=S,
                  wall_ms=wall_ms)

    wide_backward_split(card)

    trainer, tcfg, data, gen = flagship_ctx
    S, n_rays = tcfg.update_den_freq, 4096
    batch = RayBatcher(data.n_images, data.n_pixels, n_rays, seed=3)
    ids = [batch.next() for _ in range(S)]
    rays = [data.rays_for_pixels(*i) for i in ids]
    block = (np.stack([o for o, _ in rays]), np.stack([d for _, d in rays]),
             np.stack([data.pixel_values(*i) for i in ids]))
    metrics = trainer.train_block(*block, generator=gen)
    samples = metrics["n_samples"].float().mean().item()
    wall_ms = profiling.wall_ms(lambda: trainer.train_block(*block, generator=gen))
    prof = profiling.device_profile(lambda: trainer.train_block(*block, generator=gen))
    print_profile(f"profile: fused flagship train block of {S} steps at {n_rays} rays "
                  f"({samples:.0f} samples per step), per step", prof, card, per=S,
                  wall_ms=wall_ms)


# where each kernel comes from: its source and the TPU kernel (file:line of
# the function that reaches pl.pallas_call) it replaces; "also_replaces"
# lists the other probe kernels of the same operation
KERNELS = {
    "fused_mlp": ("fused_mlp.cu", "myc_nerfs_tpu/ops/pallas/fused_mlp.py:34", []),
    "fused_mlp_bwd": ("fused_mlp.cu", "myc_nerfs_tpu/ops/pallas/fused_mlp.py:47", []),
    "fused_mlp_wide": ("fused_mlp.cu", "myc_nerfs_tpu/ops/pallas/fused_mlp.py:34", []),
    "fused_mlp_wide_bwd": ("fused_mlp.cu", "myc_nerfs_tpu/ops/pallas/fused_mlp.py:47", []),
    "brick_encode": ("grid_encode.cu", "scripts/probe_r2d_chunked.py:79",
                     ["scripts/probe_r2c_rates.py:187", "scripts/probe_r2f_scale.py:40"]),
    "brick_encode_bwd": ("grid_encode.cu", "scripts/probe_r2d_chunked.py:162", []),
    "gather_rows": ("grid_probe.cu", "scripts/probe_r2_pallas.py:83",
                    ["scripts/probe_r2_pallas.py:108", "scripts/probe_r2_pallas.py:138",
                     "scripts/probe_r2b_kernel.py:60", "scripts/probe_r2b_kernel.py:87",
                     "scripts/probe_r2c_rates.py:41", "scripts/probe_r2c_rates.py:62",
                     "scripts/probe_r2c_rates.py:85", "scripts/probe_r2c_rates.py:162",
                     "scripts/probe_r2d_chunked.py:46", "scripts/probe_r2e_bisect.py:30",
                     "scripts/probe_r2e_bisect.py:45", "scripts/probe_r2e_bisect.py:60",
                     "scripts/probe_r2e_bisect.py:83", "scripts/probe_r2e_bisect.py:102"]),
    "gather_lanes": ("grid_probe.cu", "scripts/probe_r2_pallas.py:38",
                     ["scripts/probe_r2_pallas.py:62"]),
    "scatter_add_rows": ("grid_probe.cu", "scripts/probe_r2b_kernel.py:115",
                         ["scripts/probe_r2b_kernel.py:141", "scripts/probe_r2c_rates.py:113",
                          "scripts/probe_r2c_rates.py:135", "scripts/probe_r2d_chunked.py:126",
                          "scripts/probe_r2e_bisect.py:121", "scripts/probe_r2f_scale.py:108"]),
    "smem_scratch": ("grid_probe.cu", "scripts/probe_r2b_kernel.py:36", []),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    phase_build()
    stats = {"fused_mlp": phase_kernel(fm), "fused_mlp_bwd": phase_kernel_bwd(fm)}
    stats["brick_encode"], stats["brick_encode_bwd"] = phase_kernel_encode()
    stats["fused_mlp_wide"], stats["fused_mlp_wide_bwd"] = phase_kernel_wide(fm)
    probe = phase_probe()
    grid, render = phase_slice(smi)
    train, train_ctx = phase_train(smi)
    nerf, nerf_ctx = phase_nerf_train(smi)
    flagship, flagship_ctx = phase_flagship_fused(smi, nerf_ctx)
    hash_march = phase_hash_march(smi)
    phase_profile(smi, train_ctx, flagship_ctx)
    phase_split(smi, train_ctx)
    runs = (grid, render, train, nerf, flagship, hash_march)  # the main-path runs
    kernels = []
    for name, (source, replaces, also) in KERNELS.items():
        if name in probe:
            entry = probe[name]
        else:
            entry = {"launches": sum(run[name] for run in runs), **stats[name]}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"myc_nerfs_tpu_torch/csrc/{source}",
                        "replaces": replaces, "also_replaces": also, **entry})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
