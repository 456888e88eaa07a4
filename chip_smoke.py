"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, each ending in one line (a failure exits non-zero):
1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every kernel source, myc_nerfs_tpu_torch/csrc/*.cu, with
   nvcc, all at once (ops/cuda/_build.py::build_all),
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
5b. march: the fused NGP march kernel (csrc/march.cu, through
   render/ngp_render.py::march_rays_fused) against march_rays_fused_plain on
   Car's cascaded grid (the seeded model after 16 grid updates, and the same
   grid with its values x MARCH_DENSE, where rays truncate) at n_coarse 512
   and 64 samples, at the main path's two shapes: one render chunk (~4096
   rays through a frame, xi None) and a training batch (MARCH_TRAIN_RAYS
   rays of random pixels, xi drawn). Every output must equal the plain
   version's bit for bit on every ray but those whose coarse logT_prev lies
   within the two summation orders' rounding of log(eps)
   (tests/test_torch_cuda_march.py), at most one in a thousand; the device
   time (graph_ms) and the call's (median_ms) of both, and the bound of the
   bytes the kernel must write and read (march_bound). Then the backward
   kernel at the training batch: the gradient of a random linear function
   of the outputs to rays_o, rays_d and xi against autograd through the
   plain version (the card tests' per-ray tolerance), and the backward's
   time against the plain version's (median_ms: autograd runs it on the
   forward's stream, outside a graph capture).
5c. rgb_input: the NGP rgb-MLP input kernel (csrc/rgb_input.cu, x = [h |
   SH(dirs * 2 - 1)]) against rgb_input_plain, the eager composition it
   replaces, at one render chunk's 262144 rows, bf16 and f32, on random h and
   directions with the 0 and 1 borders: every element equal bit for bit; the
   device time (graph_ms) and the call's (median_ms) of both, and the bound of
   the bytes the kernel must move (h and dirs in, x out: rgb_input_bound).
5d. composite: the NGP compositor kernel (csrc/composite.cu, through
   render/ngp_render.py::composite_marched) against composite_marched_plain,
   the eager composition it replaces, on phase 5b's Car samples with the
   seeded field's raw: one render chunk (K = n_samples, one background)
   and one training batch (K = n_compact, per-ray backgrounds), to the card
   tests' tolerances (tests/test_torch_cuda_composite.py, rays within
   rounding of the early stop's eps left out); the device and call times of
   both and the bound of the bytes the kernel must move (composite_bound).
   Then the backward kernel at the training batch: the gradient to raw of
   a random linear function of rgb against autograd through the plain
   version (norm of the difference over the norm), and both backwards'
   call times. Phase 7 counts its launches over two frames (one per chunk).
6. probe: the gather / scatter-add rate probes of cli/probe_grid.py, one
   line each, with their library calls and bounds; every probe must be
   correct. The kernels line's gather_lanes entry is the 65536x128 probe
   (96 MB moved), where its bytes, not the launch, set the time.
7. slice: run_net.build_trainer on configs/ngp/Car.py (L16F2, 2^19,
   aabb_scale 4, fp16 -> bf16 MLPs, use_fully) with seeded random
   weights, 16 occupancy-grid updates, then two 800x800 frames rendered
   along the spherical path; the frames must be finite and not all
   background, and the grid updates and the render must each have run
   the encode and MLP kernels, and the march, rgb-input and compositor
   kernels once per 4096-ray chunk (the compositor's backward never). One
   chunk of rays is rendered again
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
   precedes them): one 800x800 frame and one train block at 4096 rays
   under torch.profiler, with the device's busy share of the wall time
   (utils/profiling.py); the wide fused-MLP
   backward by kernel in bf16 and in f32, and one train block of the fused
   flagship (phase 13).
10. split: phase 8's encode comparison at many trained states: the config
   trained again from another seed, checked after each of its 16 blocks on
   two batches; at each, phase 8's check of both kernels against the plain
   path with its per-batch bound too; one line per check and a summary.
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
15. garf_train: cli/train.main --model=garf on configs/barf/Easyship.yaml at
   its widths (6 x 256 gaussian layers, no PE, 2040 rays x 128 samples, f32)
   on the textured synthetic scene (12 views at 128x128) with camera.noise
   0.06 and pose correction from step 0, GARF_STEPS steps: the train PSNR
   must rise, the loss and params stay finite, model.ckpt restore bit for
   bit into a fresh state (restored, saved again: the same bytes) and
   transform_train.json hold the restored state's refined poses; then ms
   per step, rays/s, samples/s and the device's busy share (profiler).
16. pose_recovery: tests/test_barf_joint.py's protocol (8 views at 20x20,
   1280 rays x 32 samples, noise 0.04, 200 refinement steps) at GARF width
   (8 x 256): the field fitted on clean poses (POSE_FIT_STEPS), then se(3)
   noise injected with refinement on and the field's rate at 1e-6; the raw
   rotation and translation errors must fall below half their start.
17. nerf_grad: one GARF and one BARF (c2f at progress 0.3) batch of
   NERF_GRAD_RAYS rays with fixed draws: every parameter's and se3_refine's
   gradient on the card in f32 against the same batch on the CPU in f64,
   within NERF_GRAD_TOL (by model); with TF32 turned on the check must fail
   (it sees a silent loss of precision).
18. barf_train: phase 15 for --model=barf on configs/barf/barf_blender.yaml
   (8 x 256, skip 4, PE 10/4, c2f [0.1, 0.5], noise 0.15, 1020 rays x 128
   samples), BARF_STEPS steps.
19. tensorf_train: cli/tensorf_train.main on configs/tensorf/Coffee.txt at
   its widths (VM-split 16x3 / 48x3, app_dim 27, MLP_Fea 128, 4096 rays,
   2097156 -> 27e6 voxels, step_ratio 0.5, Coffee's TV and L1) from a
   temporary copy: the textured synthetic scene (12 views at 128x128),
   demo_synthetic.txt's bbox, near and far, the events and n_iters / 10
   (800 steps, every event once): the train PSNR must rise, the params
   stay finite, the final grid be n_to_reso(27e6) of the shrunk aabb, the
   checkpoint restore bit for bit; --render_only renders with PSNR and
   SSIM, --export_mesh writes a .ply with faces.
20. tensorf_step: the step at Coffee's hardest stage (bench.py::
   measure_tensorf_train's shape: 300^3 VM-split, 4096 rays x 1036
   samples, a 256^3 ball alpha mask, dilated; then no mask): ms per step,
   rays/s, samples/s, the gated and shaded samples, host syncs per step,
   peak memory, device time, busy share, top operations and their split.
21. tensorf_variants: phase 19's treatment of Scar.txt (REFTensoRF, 800
   steps) and Scarf.txt (NerfPlusPlus, 256 steps), the PSNR must rise; then one
   batch of VM-split, REF and NeRF++ at 48^3: every parameter's gradient,
   card f32 against CPU f64 (TF32 off), within TENSORF_GRAD_TOL.
22. evaluate: cli/train --model=garf on Easyship.yaml (phase 15's scene,
   EVAL_STEPS steps), then cli/evaluate with optim.test_photo from view
   EVAL_START: every output file must exist and the poses be finite; each
   view's PSNR, test-time iterations, stop reason and ms per iteration.
23. pose_chain: cli/pose_chain, the slice's main path, at L16F2 width cut to
   CHAIN_ARGV (GARF 512 steps, NGP 256 per leg, 128^2, 12 views, tt 100):
   each NGP leg's train PSNR must rise, the four NGP kernels run, and the
   march and compositor kernels and their backwards (test-time
   optimisation) run; on view 0 of the gt leg, d loss / d se3 through the
   kernels (one compositor launch each way) against the plain versions
   (march_rays_fused_plain for the march, composite_marched_plain for the
   compositor) within CHAIN_GRAD_TOL;
   the test-time backward kernel's time at its rows (its dW is discarded).
24. tensorf_budget: cli/tensorf_budget on Coffee.txt at 128^2, 12 views,
   BUDGET_STEPS steps straight (twice) and split by --stop_at / --resume:
   the split run equals the straight one within BUDGET_SPLIT_FACTOR times
   the straight runs' spread.
25. umbrella: cli/test_scenes --synthetic (its result images must exist)
   and entry() (rgb finite, brick_encode and fused_mlp launched, equal to
   the plain versions' render within ENTRY_TOL).
26. multichip: cli/multichip's legs at full width on MULTICHIP_RANKS spawned
   ranks (NCCL, one per card, when 4 cards are visible; else gloo, the
   ranks sharing the card): the L16F2 GroupTP ngp block (16 steps, 64 rays
   per data shard) and its render at 2 x 2, GARF and TensoRF at 4 x 1; each
   leg against one process over the whole batch with the same draws
   (per-step losses and the params after the block within MULTICHIP_TOL),
   the replicas bit-equal after every step, the DP render equal bit for
   bit to one process's render of the same state, and the four NGP
   kernels launched on every rank (their counts join the kernels line).
Then a JSON line describing each kernel (for the fused MLP and encode
kernels its numbers are the bf16 ones, the Car slice's dtype, summed over
the shapes; ``ms`` is graph_ms, ``call_ms`` median_ms), and last the
result line. Each main-path run (the grid updates, the render, the probes,
the training) starts with every launch count at 0 and reads them right
after it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
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
TRAIN_KERNELS = ("fused_mlp", "fused_mlp_bwd", "brick_encode", "brick_encode_bwd",
                 "rgb_input", "ngp_composite", "ngp_composite_bwd")
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
# through both kernels against the plain path: their gradient is the MLP's
# dx propagated through the encode's weights, and the dx elements of the
# two paths mostly sit within one bf16 rounding (the tensor cores sum in
# another order than cuBLAS). The limit is computed in each run
# (table_e2e_bounds): one bf16 ulp of every dx element, all of one sign,
# propagated through the plain encode backward, over the plain gradient's
# norm, plus TABLE_GRAD_REL_TOL for the atomics. It bounds the norm, not
# each element: a few thousand dx elements a batch (< 0.05%) sit 4 to ~480
# ulps apart, and the count and the largest distance are printed. On an
# H100 80GB HBM3 at 700 W the worst of 64 checks read 3.968e-03 on table 7
# at 0.648 of its bound, ten elements carrying 98% of that difference
GRAD_REL_TOL = 2.0 ** -7
TABLE_GRAD_REL_TOL = 1e-5
ENCODE_RAYS, ENCODE_SAMPLES = 4096, 64   # one chunk of the Car render
# phase 5b: the training batch's rays (the NGP train cell settles at 15.9-22.4 k
# rays a step) and the factor on the grid's values of its denser state
MARCH_TRAIN_RAYS = 20480
MARCH_DENSE = 64.0
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
# phases 15-18 (the BARF family, f32, TF32 off): cli/train's scalars every
# NERF_SCALAR_EVERY steps; the train PSNR's rise from the first scalar to
# the last must reach GARF_PSNR_RISE / BARF_PSNR_RISE (dB), half, rounded
# down, of the first chip runs' rises on an H100 80GB HBM3 at 700 W: GARF
# 6.260 -> 11.179 in 256 steps (lr 1e-4), BARF 6.461 -> 16.616 in 128
GARF_STEPS, BARF_STEPS, NERF_SCALAR_EVERY = 256, 128, 32
GARF_PSNR_RISE = 2.0
BARF_PSNR_RISE = 5.0
# the step's times: warm-up steps, timed steps, profiled steps
NERF_WARMUP_STEPS, NERF_TIMED_STEPS, NERF_PROFILED_STEPS = 3, 20, 4
# phase 16: tests/test_barf_joint.py's protocol (its scene, rays, samples,
# noise and refinement) at GARF width (8 x 256, NeRFTrainConfig's default,
# as scripts/garf_budget.py): fit steps and learning rates, the injected
# noise, refine steps and pose learning rates. GARF fits slowly (its sigma
# 0.1 gaussians on raw xyz): at the test's 350 steps and lr 5e-3 its train
# PSNR stays near 13-18 dB and the poses drift; 2000 steps at lr 2e-3 ->
# 5e-4 reach ~24 dB, and the raw errors fall to 0.34 (R) and 0.37 (t) of
# their start (first chip run, H100 80GB HBM3, 700 W)
POSE_ARCH = dict(model="garf")
POSE_VIEWS, POSE_SIZE, POSE_RAYS, POSE_SAMPLES = 8, 20, 1280, 32
POSE_FIT_STEPS, POSE_FIT_LR = 2000, (2e-3, 5e-4)
POSE_NOISE, POSE_REFINE_STEPS, POSE_LR = 0.04, 200, (5e-3, 1e-3)
# phase 17: rays of the gradient batch (the CPU f64 reference runs them
# all), and the limit on |a-b|/|b| per tensor, card f32 against CPU f64, by
# model: ~4x the first chip run's largest reading (H100 80GB HBM3, 700 W:
# GARF 2.149e-3 params, 2.528e-3 se3_refine; BARF 3.090e-4, 2.921e-4).
# The f32 error is the problem's own: GARF's sigma 0.1 gaussians scale each
# rounding ~100x per layer, and the CPU's f32 reads alike. TF32 read GARF
# 1.22 and BARF 4.5e-2 / 8.9e-2 there: far beyond either limit
NERF_GRAD_RAYS = 96
NERF_GRAD_TOL = {"garf": 1e-2, "barf": 1.5e-3}
# phases 19-21 (TensoRF, f32, TF32 off): the synthetic scene of the CLI
# runs; the steps of each run and its "iter N psnr" lines' interval; the
# train PSNR's rise (phase 19: first line to last; phase 21: first line to
# the last before the first mask update) must reach half, rounded down, of
# the first chip runs' rises (H100 80GB HBM3, 700 W): Coffee 12.450 ->
# 35.480 in 800 steps; Scar 12.45 -> 31.06 at step 192, Scarf 4.42 ->
# 17.03 at step 64
TENSORF_VIEWS, TENSORF_SIZE = 12, 128
TENSORF_STEPS, TENSORF_LOG_EVERY = 800, 50
TENSORF_PSNR_RISE = 11.0
TENSORF_VARIANT_STEPS = {"REFTensoRF": 800, "NerfPlusPlus": 256}
TENSORF_VARIANT_LOG_EVERY = 32
TENSORF_VARIANT_PSNR_RISE = {"REFTensoRF": 9.0, "NerfPlusPlus": 6.0}
# phase 20: warm-up, timed and profiled steps per stage
TENSORF_STEP_WARMUP, TENSORF_STEP_TIMED, TENSORF_STEP_PROFILED = 3, 10, 3
# phase 21's gradient batch, and the limit on |a-b|/|b| per tensor, card f32
# against CPU f64: ~4x the first chip run's largest reading (H100 80GB
# HBM3, 700 W: VM-split 6.203e-06, REF 1.160e-05, NeRF++ 1.511e-05)
TENSORF_GRAD_RAYS = 256
TENSORF_GRAD_TOL = 6e-5
# the encode backward's instance on the Car path (F = 2, bf16), mangled
ENCODE_BWD_SASS = "brick_encode_bwd_kernelILi2ELb1E"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


# every kernel of the port, by its name in the JSON line (the registry's
# counter is launch.<name>)
KERNELS = ("fused_mlp", "fused_mlp_bwd", "fused_mlp_wide", "fused_mlp_wide_bwd",
           "brick_encode", "brick_encode_bwd", "march_rays_fused", "march_rays_fused_bwd",
           "rgb_input", "ngp_composite", "ngp_composite_bwd", "gather_rows",
           "gather_lanes", "scatter_add_rows", "smem_scratch")


def reset_launches() -> None:
    torch.cuda.synchronize()
    profiling.reset()


def read_launches() -> dict:
    torch.cuda.synchronize()
    counts = profiling.counts(traced=False)
    return {name: counts[f"launch.{name}"] for name in KERNELS}


def phase_build() -> None:
    """nvcc on every source at once; each build is printed with its time."""
    from myc_nerfs_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    root = _build.PKG.parent
    for name, (path, secs) in results.items():
        print(f"build: {(_build.CSRC / name).relative_to(root)} -> {path.relative_to(root)} "
              f"in {secs:.2f} s", flush=True)
    print(f"build: all sources in {time.perf_counter() - t0:.2f} s (in parallel)",
          flush=True)
    # the bf16 MLP kernels must run on the tensor cores: HMMA (mma.sync) in
    # the narrow kernels' SASS, HGMMA (wgmma) in the wide ones'; the encode
    # backward adds by reductions (RED), not returning atomics
    mlp_lib, encode_lib = results["fused_mlp.cu"][0], results["grid_encode.cu"][0]
    hmma = sass_counts(mlp_lib, SASS_KERNELS, ("HMMA",))
    hgmma = sass_counts(mlp_lib, WGMMA_KERNELS, ("HGMMA",))
    red = sass_counts(encode_lib, (ENCODE_BWD_SASS,), ("RED", "ATOM"))[ENCODE_BWD_SASS]
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


def march_inputs():
    """Car's trainer (seeded weights) after 16 grid updates; its occupancy
    state and a denser one (the grid's values x MARCH_DENSE, the bitfield
    and mean re-derived), and the main path's two batches, each (rays_o,
    rays_d, xi, K): one render chunk through a frame (xi None, n_samples)
    and MARCH_TRAIN_RAYS rays of random pixels of 8 views (xi drawn,
    n_compact)."""
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.geom import rays as rays_lib
    from myc_nerfs_tpu_torch.geom.camera_path import path_spherical
    from myc_nerfs_tpu_torch.render import occupancy as occ

    gen = torch.Generator(device="cuda").manual_seed(4)
    trainer, _ = run_net.build_trainer(load_config("configs/ngp/Car.py"), gen,
                                       device="cuda")
    with torch.no_grad():
        for _ in range(16):
            trainer.state = trainer.state._replace(
                occ=trainer.grid_update(trainer.state.occ, gen))
        grid = trainer.state.occ
        dense = torch.where(grid.density_grid < 0, grid.density_grid,
                            grid.density_grid * MARCH_DENSE)
        bits, mean = occ.update_bitfield(trainer.occ_cfg, dense)
        states = {"grid": grid, f"grid_x{MARCH_DENSE:g}": grid._replace(
            density_grid=dense, bitfield=bits, mean_density=mean)}
        poses = [run_net.path_pose(p).to("cuda") for p in path_spherical(8)]
        render_o, render_d = chunk_rays(poses[0])
        d = rays_lib.get_ray_directions(H, W, (W * 0.6, W * 0.6), device="cuda").reshape(-1, 3)
        view = torch.randint(0, len(poses), (MARCH_TRAIN_RAYS,), device="cuda", generator=gen)
        pix = torch.randint(0, H * W, (MARCH_TRAIN_RAYS,), device="cuda", generator=gen)
        c2w = torch.stack(poses)[view]
        train_d = (c2w[:, :3, :3] @ d[pix][:, :, None])[..., 0]
        train_d = train_d / torch.linalg.norm(train_d, dim=-1, keepdim=True)
        xi = torch.rand((MARCH_TRAIN_RAYS, 1), device="cuda", generator=gen)
    rcfg = trainer.rcfg
    batches = {"render": (render_o, render_d, None, rcfg.n_samples),
               "train": (c2w[:, :3, 3].contiguous(), train_d, xi, rcfg.n_compact)}
    return trainer, states, batches


def march_bound(n_rays: int, n_samples: int, has_xi: bool) -> dict:
    """The H100 bound of the bytes the march kernel must move for n_rays
    rays of n_samples samples, each once: the rays (and the jitter) in,
    positions, t, valid, dt and dirs out. The density-grid probes are left
    out: the grid stays in the L2."""
    from myc_nerfs_tpu_torch.utils.timing import roofline

    nbytes = n_rays * (24 + (4 if has_xi else 0) + 4 + 12) + n_rays * n_samples * (12 + 4 + 1)
    return roofline(0, nbytes, torch.float32)


def phase_march():
    """Phase 5b: the march kernel and its backward against
    march_rays_fused_plain. Returns the forward's and the backward's
    entries of the kernels line."""
    from myc_nerfs_tpu_torch.render import ngp_render as nr

    tests = card_tests("test_torch_cuda_march")
    trainer, states, batches = march_inputs()
    occ_cfg, rcfg = trainer.occ_cfg, trainer.rcfg
    eps = rcfg.early_stop_eps
    near = 2 * (rcfg.n_coarse - 1) * 2.0 ** -24 * abs(float(np.log(np.float32(eps))))
    stats = {}
    for sname, state in states.items():
        for bname, (o, d, xi, K) in batches.items():
            def kernel():
                return nr.march_rays_fused(occ_cfg, rcfg, state, o, d, xi, n_samples=K)

            def plain(trunc_eps=None):
                return nr.march_rays_fused_plain(occ_cfg, rcfg, state, o, d, xi,
                                                 n_samples=K, trunc_eps=trunc_eps)

            N = o.shape[0]
            with torch.no_grad():
                got, want = kernel(), plain()
                same = torch.ones(N, dtype=torch.bool, device="cuda")
                for a, b in zip(got, want):
                    a, b = a.contiguous(), b.contiguous()
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    same &= (a == b).reshape(N, -1).all(1)
                differing = ~same
                margin = tests.truncation_margin(occ_cfg, rcfg, state, o, d)
                near_rays = margin <= near
                truncated = (plain(0.0).valid != want.valid).any(1)
                t_k = graph_ms(kernel)
                t_c = median_ms(kernel)
                t_p = graph_ms(plain)
                t_pc = median_ms(plain)
            work = march_bound(N, K, xi is not None)
            n_diff, n_far = int(differing.sum()), int((differing & ~near_rays).sum())
            ok = n_far == 0 and n_diff <= max(1, N // 1000)
            print(f"march: {bname} {N}x{K} n_coarse={rcfg.n_coarse} state={sname} "
                  f"valid={got.valid.float().mean().item():.4f} "
                  f"truncated_rays={int(truncated.sum())} differing_rays={n_diff} "
                  f"near_boundary_rays={int(near_rays.sum())} (margin <= {near:.3e}) "
                  f"differing_off_boundary={n_far} {'ok' if ok else 'BREACH'} "
                  f"{bound_fields(t_k, work)} call_ms={t_c:.4f} plain_ms={t_p:.4f} "
                  f"plain_call_ms={t_pc:.4f}", flush=True)
            if not ok:
                fail(f"march kernel {bname} on {sname}: {n_diff} rays differ, "
                     f"{n_far} away from the truncation boundary")
            if sname == "grid" and bname == "render":
                stats = {"differing_rays": n_diff, "ms": t_k,
                         "call_ms": t_c, "plain_ms": t_p, "plain_call_ms": t_pc,
                         "library_ms": None, "bound_ms": work["bound_ms"],
                         "bound_by": work["bound_by"]}
            if bname == "train":
                bwd = march_backward(tests, nr, occ_cfg, rcfg, state, o, d, xi, K, ~differing,
                                     sname)
                if sname == "grid":
                    bwd_stats = bwd
    return stats, bwd_stats


def card_tests(name: str):
    """tests/<name>.py, loaded from its path, for the helpers a phase shares
    with the card tests (test_torch_cuda_march: truncation_margin,
    march_loss, rays_off; test_torch_cuda_composite: near_eps,
    output_errors and the tolerances)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def march_backward(tests, nr, occ_cfg, rcfg, state, o, d, xi, K, keep, sname: str) -> dict:
    """The march's backward kernel against autograd through the plain
    version at one batch: the gradients' agreement on the rays ``keep``
    (whose forward outputs are equal), and both backwards' times."""
    def backward(fn):
        leaves = [x.clone().requires_grad_(True) for x in (o, d, xi)]
        out = fn(occ_cfg, rcfg, state, *leaves, n_samples=K)
        loss = tests.march_loss(out, torch.Generator(device="cuda").manual_seed(5))
        return leaves, loss

    k_leaves, k_loss = backward(nr.march_rays_fused)
    p_leaves, p_loss = backward(nr.march_rays_fused_plain)
    got = torch.autograd.grad(k_loss, k_leaves, retain_graph=True)
    want = torch.autograd.grad(p_loss, p_leaves, retain_graph=True)
    off = {name: int((keep & rays).sum()) for name, rays in tests.rays_off(got, want).items()}
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    t_k = median_ms(lambda: torch.autograd.grad(k_loss, k_leaves, retain_graph=True))
    t_p = median_ms(lambda: torch.autograd.grad(p_loss, p_leaves, retain_graph=True))
    ok = finite and not any(off.values())
    print(f"march_bwd: train {o.shape[0]}x{K} state={sname} rays off the plain gradient "
          f"{off} finite={finite} {'ok' if ok else 'BREACH'} backward call_ms={t_k:.4f} "
          f"plain_call_ms={t_p:.4f}", flush=True)
    if not ok:
        fail(f"march backward on {sname}: gradients off the plain version's {off}")
    return {"rays_off_plain_gradient": off, "call_ms": t_k, "plain_call_ms": t_p,
            "library_ms": None}


def rgb_input_bound(rows: int, dtype: torch.dtype) -> dict:
    """The H100 bound of the bytes the rgb-input kernel must move for
    ``rows`` rows, each once: h [rows, 16] and dirs [rows, 3] f32 in, x
    [rows, 32] out."""
    from myc_nerfs_tpu_torch.utils.timing import roofline

    size = torch.finfo(dtype).bits // 8
    return roofline(0, rows * (16 * size + 12 + 32 * size), dtype)


def phase_rgb_input():
    """Phase 5c: the rgb-input kernel against rgb_input_plain at one render
    chunk's rows, bf16 and f32. Returns the bf16 entry of the kernels line,
    with the f32 numbers beside it."""
    from myc_nerfs_tpu_torch.ops.cuda import rgb_input as ri

    g = torch.Generator(device="cuda").manual_seed(17)
    d = torch.rand((ROWS, 3), device="cuda", generator=g)
    d[::7] = torch.randint(0, 2, (d[::7].shape[0], 3), device="cuda", generator=g).float()
    stats = {}
    for dtype in (torch.bfloat16, torch.float32):
        h = (torch.rand((ROWS, 16), device="cuda", generator=g) * 8 - 4).to(dtype)
        with torch.no_grad():
            got, want = ri.rgb_input(h, d), ri.rgb_input_plain(h, d)
            view = torch.int16 if dtype == torch.bfloat16 else torch.int32
            differing = int((got.view(view) != want.view(view)).sum())
            t_k = graph_ms(lambda: ri.rgb_input(h, d))
            t_c = median_ms(lambda: ri.rgb_input(h, d))
            t_p = graph_ms(lambda: ri.rgb_input_plain(h, d))
            t_pc = median_ms(lambda: ri.rgb_input_plain(h, d))
        work = rgb_input_bound(ROWS, dtype)
        ok = differing == 0
        print(f"rgb_input: {dtype_name(dtype)} {ROWS}x32 differing_elements={differing} "
              f"{'ok' if ok else 'BREACH'} {bound_fields(t_k, work)} call_ms={t_c:.4f} "
              f"plain_ms={t_p:.4f} plain_call_ms={t_pc:.4f}", flush=True)
        if not ok:
            fail(f"rgb_input kernel {dtype_name(dtype)}: {differing} elements differ from "
                 "the plain composition")
        stats[dtype_name(dtype)] = {"differing_elements": differing, "ms": t_k,
                                    "call_ms": t_c, "plain_ms": t_p, "plain_call_ms": t_pc,
                                    "library_ms": None, "bound_ms": work["bound_ms"],
                                    "bound_by": work["bound_by"]}
    return {**stats["bfloat16"], "float32": stats["float32"]}


def composite_bound(n_rays: int, n_samples: int) -> dict:
    """The H100 bound of the bytes the compositor kernel must move for
    n_rays rays of n_samples samples, each once: raw [N, K, 4] f32, t and
    valid [N, K] and dt (one f32 per ray, the march's step broadcast over
    the samples) in; rgb, depth and opacity out (n_samples is valid.sum(),
    torch's launch)."""
    from myc_nerfs_tpu_torch.utils.timing import roofline

    nbytes = n_rays * n_samples * (16 + 4 + 1) + n_rays * (4 + 12 + 4 + 4)
    return roofline(0, nbytes, torch.float32)


def phase_composite():
    """Phase 5d: the compositor kernel against composite_marched_plain on
    marched Car samples and the seeded field's raw, at one render chunk
    (K = n_samples, one background) and one training batch (K = n_compact,
    per-ray backgrounds), then the backward kernel at the training batch
    against autograd through the plain version. Returns the forward's and
    the backward's entries of the kernels line. (Phase 7 counts the
    forward's launches over two 800x800 frames: one per chunk, 314.)"""
    from myc_nerfs_tpu_torch.render import ngp_render as nr

    tests = card_tests("test_torch_cuda_composite")
    trainer, states, batches = march_inputs()
    occ_cfg, rcfg, state = trainer.occ_cfg, trainer.rcfg, states["grid"]
    eps = rcfg.early_stop_eps
    if eps != tests.EPS:
        fail(f"Car's early_stop_eps {eps} is not the card tests' {tests.EPS}")
    g = torch.Generator(device="cuda").manual_seed(19)
    fwd = bwd = {}
    for bname, (o, d, xi, K) in batches.items():
        N = o.shape[0]
        bg = (torch.ones(3, device="cuda") if bname == "render"
              else torch.rand((N, 3), device="cuda", generator=g))
        with torch.no_grad():
            marched = nr.march_rays_fused(occ_cfg, rcfg, state, o, d, xi, n_samples=K)
            raw = trainer.model(marched.positions.reshape(-1, 3),
                                marched.dirs.reshape(-1, 3)).reshape(N, K, 4)

            def kernel():
                return nr.composite_marched(raw, marched, bg, eps)

            def plain():
                return nr.composite_marched_plain(raw, marched, bg, eps)

            got, want = kernel(), plain()
            keep = ~tests.near_eps(raw, marched, eps)
            errors = tests.output_errors(got, want, keep)
            same_n = int(got.n_samples) == int(want.n_samples)
            t_k, t_c = graph_ms(kernel), median_ms(kernel)
            t_p, t_pc = graph_ms(plain), median_ms(plain)
        n_near = int((~keep).sum())
        work = composite_bound(N, K)
        ok = (same_n and tests.within_tolerances(errors)
              and n_near <= max(1, int(tests.NEAR_SHARE * N)))
        print(f"composite: {bname} {N}x{K} valid={marched.valid.float().mean().item():.4f} "
              f"near_eps_rays={n_near} max_abs rgb={errors['rgb']:.3e} "
              f"opacity={errors['opacity']:.3e} depth_rel={errors['depth_rel']:.3e} "
              f"n_samples_equal={same_n} {'ok' if ok else 'BREACH'} "
              f"{bound_fields(t_k, work)} call_ms={t_c:.4f} plain_ms={t_p:.4f} "
              f"plain_call_ms={t_pc:.4f}", flush=True)
        if not ok:
            fail(f"compositor kernel {bname}: outside the card tests' tolerances")
        if bname == "render":
            fwd = {"max_abs_rgb": errors["rgb"], "near_eps_rays": n_near, "ms": t_k,
                   "call_ms": t_c, "plain_ms": t_p, "plain_call_ms": t_pc, "library_ms": None,
                   "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
            continue

        g_rgb = torch.randn((N, 3), device="cuda", generator=g)

        def backward(fn):
            r = raw.clone().requires_grad_()
            return r, (fn(r, marched, bg, eps).rgb * g_rgb).sum()

        r_k, l_k = backward(nr.composite_marched)
        r_p, l_p = backward(nr.composite_marched_plain)
        (g_k,) = torch.autograd.grad(l_k, r_k, retain_graph=True)
        (g_p,) = torch.autograd.grad(l_p, r_p, retain_graph=True)
        err = ((g_k - g_p)[keep].norm() / g_p[keep].norm()).item()
        t_k = median_ms(lambda: torch.autograd.grad(l_k, r_k, retain_graph=True))
        t_p = median_ms(lambda: torch.autograd.grad(l_p, r_p, retain_graph=True))
        ok = err <= tests.GRAD_RTOL and bool(torch.isfinite(g_k).all())
        print(f"composite_bwd: train {N}x{K} raw gradient |a-b|/|b| {err:.3e} (tol "
              f"{tests.GRAD_RTOL:g}) {'ok' if ok else 'BREACH'} backward call_ms={t_k:.4f} "
              f"plain_call_ms={t_p:.4f}", flush=True)
        if not ok:
            fail(f"compositor backward: raw gradient {err:.3e} off autograd's")
        bwd = {"grad_rel_err": err, "call_ms": t_k, "plain_call_ms": t_p, "library_ms": None}
    return fwd, bwd


# each probe kernel's entry in the JSON line: the probe record it takes its
# numbers from
PROBE_RECORDS = {"gather_rows": "gather_rows_float32",
                 "gather_lanes": "gather_lanes_65536x128",
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
    bg = torch.tensor(trainer.cfg.background_color, dtype=torch.float32, device="cuda")
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
          f"brick_encode={launches['brick_encode']} "
          f"march_rays_fused={launches['march_rays_fused']} "
          f"rgb_input={launches['rgb_input']} ngp_composite={launches['ngp_composite']} "
          f"ngp_composite_bwd={launches['ngp_composite_bwd']} [{card}]", flush=True)
    if tuple(rgb.shape) != (FRAMES, H, W, 3) or not torch.isfinite(rgb).all():
        fail("render output is not finite or has the wrong shape")
    if non_bg < 1e-3:
        fail("render is all background")
    for name, counts in (("grid update", grid_launches), ("render", launches)):
        if counts["fused_mlp"] == 0 or counts["brick_encode"] == 0:
            fail(f"the {name} did not run the fused_mlp and brick_encode kernels")
    chunks = FRAMES * math.ceil(H * W / 4096)
    for kernel in ("march_rays_fused", "rgb_input", "ngp_composite"):
        if launches[kernel] != chunks:
            fail(f"the render ran the {kernel} kernel {launches[kernel]} times, "
                 f"not once per chunk ({chunks})")
    if launches["ngp_composite_bwd"]:
        fail("the render ran the compositor's backward kernel")

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
    plain, plain_seen = train_gradients(trainer, batch, False, False)
    split = encode_split(trainer, batch, kern)
    n_tables = len(model.tables)
    names = [f"table{i}" for i in range(n_tables)] + list(model.net.LAYERS)
    full = {n: rel(a, b) for n, a, b in zip(names, kern[0], plain)}
    bounds = table_e2e_bounds(trainer, kern[1], plain_seen, plain[:n_tables])
    dx = dx_ulps(kern[1], plain_seen)
    limit = dict(zip(names, bounds + [GRAD_REL_TOL] * len(model.net.LAYERS)))
    ok = all(v <= limit[n] for n, v in full.items())
    ok &= split_ok(split)
    print("train: gradient kernels vs plain path (encode and MLP), |a-b|/|b|: "
          + " ".join(f"{n}={v:.2e}" for n, v in full.items())
          + " tol tables (this batch's bound: one bf16 ulp of each dx element through the "
          "encode's weights, + 1e-5) " + " ".join(f"{b:.2e}" for b in bounds)
          + f" (reading / bound max {max(full[n] / b for n, b in zip(names, bounds)):.3f}; "
          f"dx elements more than one ulp apart {dx['over']} of {dx['n']}, at most "
          f"{dx['max']:.1f} ulps) mlp={GRAD_REL_TOL:.2e}; tables, "
          f"encode kernels vs plain encode under the MLP kernels: "
          + " ".join(f"table{i}={v:.2e}" for i, v in enumerate(split["tables"]))
          + f" tol {TABLE_GRAD_REL_TOL:.2e}; {split_fields(split)}", flush=True)
    if not ok:
        fail("kernel and plain path gradients disagree")

    return launches, (trainer, tcfg, data, gen)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits), 0 at 0."""
    a = x.float().abs()
    ulp = torch.pow(2.0, torch.floor(torch.log2(torch.clamp_min(a, 2.0 ** -126))) - 7)
    return torch.where(a > 0, ulp, torch.zeros_like(a))


def table_e2e_bounds(trainer, kern_seen: dict, plain_seen: dict, plain_tables) -> list:
    """Each table's limit on |a-b|/|b| between its gradient through the
    kernels and through the plain path, computed from this batch: the
    table gradient is the encode's weights applied to the MLP's dx, and
    the two paths' dx elements are taken to sit one bf16 rounding apart, so
    |a-b| <= |E^T u| elementwise with u one bf16 ulp of each dx element
    (the larger of the two paths'; the weights are >= 0), propagated by the
    plain encode backward (not the kernel under test); over the plain
    gradient's norm, plus TABLE_GRAD_REL_TOL for the atomics' order. The
    premise does not hold for every element (dx_ulps counts those that
    break it): the limit bounds the norm, not each element."""
    from myc_nerfs_tpu_torch.ops import brick_grid as bg

    model = trainer.model
    if not torch.equal(kern_seen["pos"], plain_seen["pos"]):
        fail("train: the kernel and plain paths marched different positions")
    u = bf16_ulp(torch.maximum(kern_seen["g"].float().abs(), plain_seen["g"].float().abs()))
    with torch.no_grad():
        spread = bg.paired_encode_backward_reference(
            [t.detach() for t in model.tables], kern_seen["pos"], u.to(torch.bfloat16),
            model.cfg.grid, model.levels, model.groups, model.compute_dtype)
    return [float(s.norm()) / max(float(b.float().norm()), 1e-30) + TABLE_GRAD_REL_TOL
            for s, b in zip(spread, plain_tables)]


def dx_ulps(kern_seen: dict, plain_seen: dict) -> dict:
    """How far table_e2e_bounds' premise holds: the dx elements of the
    kernel and plain paths more than one bf16 ulp apart (``over``, of
    ``n``) and the largest distance in ulps (``max``)."""
    gk, gp = kern_seen["g"].float(), plain_seen["g"].float()
    u = bf16_ulp(torch.maximum(gk.abs(), gp.abs()))
    d = (gk - gp).abs()
    ulps = torch.where(u > 0, d / torch.where(u > 0, u, torch.ones_like(u)),
                       torch.zeros_like(d))
    return {"over": int((d > u).sum()), "max": float(ulps.max()), "n": gk.numel()}


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
    each of its 16 blocks on SPLIT_BATCHES fresh batches, and phase 8's
    check of both kernels against the plain path (table_e2e_bounds) at
    each. Fails, after every state is printed, where a table breaches
    TABLE_GRAD_REL_TOL or its bound."""
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
            batch = (rays_o, rays_d, target, torch.ones_like(target), xi)
            kern = train_gradients(trainer, batch, True, True)
            split = encode_split(trainer, batch, kern)
            # phase 8's check at this state: both kernels against the plain
            # path, with this batch's bound, and the dx elements of the two
            # paths more than one bf16 ulp apart
            plain, plain_seen = train_gradients(trainer, batch, False, False)
            n = len(trainer.model.tables)
            split["e2e"] = [rel(a, c) for a, c in zip(kern[0][:n], plain[:n])]
            split["bound"] = table_e2e_bounds(trainer, kern[1], plain_seen, plain[:n])
            split["dx"] = dx_ulps(kern[1], plain_seen)
            results.append(split)
            print(f"split: step {trainer.state.step} batch {b} rays {rays_o.shape[0]}: "
                  f"tables, encode kernels vs plain encode: "
                  + " ".join(f"{v:.2e}" for v in split["tables"])
                  + "; " + split_fields(split) + "; both kernels vs plain path "
                  + " ".join(f"{v:.2e}" for v in split["e2e"]) + " bound "
                  + " ".join(f"{v:.2e}" for v in split["bound"])
                  + f", dx elements more than one bf16 ulp apart {split['dx']['over']} "
                  f"of {split['dx']['n']} (at most {split['dx']['max']:.1f} ulps)", flush=True)
        return m

    trainer.train_block = checked_block
    run_net.train_loop(trainer, tcfg, data, TRAIN_STEPS, gen, log=lambda msg: None)
    bad = [i for i, s in enumerate(results) if not split_ok(s)]
    over = [i for i, s in enumerate(results) if any(v > b for v, b in zip(s["e2e"], s["bound"]))]
    worst = max(range(len(results)), key=lambda i: max(results[i]["e2e"]))
    w = results[worst]
    t = int(np.argmax(w["e2e"]))
    print(f"split: {len(results)} checks at {len(results) // SPLIT_BATCHES} trained states; "
          f"tables max {max(max(s['tables']) for s in results):.2e}, backward alone max "
          f"{max(max(s['bwd']) for s in results):.2e} (tol {TABLE_GRAD_REL_TOL:.2e}); "
          f"checks with encode outputs differing "
          f"{sum(s['out_differ'] > 0 for s in results)}, breaching {len(bad)}; both kernels "
          f"vs plain path max {w['e2e'][t]:.3e} (check {worst}, table{t}, its bound "
          f"{w['bound'][t]:.3e}), bounds min {min(min(s['bound']) for s in results):.3e}, "
          f"reading / bound max "
          f"{max(v / b for s in results for v, b in zip(s['e2e'], s['bound'])):.3f}, "
          f"breaching {len(over)}; dx elements more than one ulp apart per check at most "
          f"{max(s['dx']['over'] for s in results)}, at most "
          f"{max(s['dx']['max'] for s in results):.1f} ulps [{card}]", flush=True)
    if bad:
        fail(f"encode kernels vs plain encode breach {TABLE_GRAD_REL_TOL} at checks {bad}")
    if over:
        fail(f"kernels vs plain path table gradients breach their bounds at checks {over}")


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
    before = read_launches()["fused_mlp_wide"]
    rgb, _ = trainer.render_image(c2ws[0], intrs[0], NERF_SIZE, NERF_SIZE)
    torch.cuda.synchronize()
    val_launches = read_launches()["fused_mlp_wide"] - before
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


def nerf_cli_args(yaml: str, model: str, steps: int, out: str) -> list:
    """cli/train's command line for a BARF-family phase: the yaml's model at
    its widths on the textured synthetic scene (NERF_VIEWS views at
    NERF_SIZE^2), steps with train scalars every NERF_SCALAR_EVERY."""
    return [f"--model={model}", f"--yaml={yaml}", "--data.synthetic", "--data.textured",
            f"--data.n_views={NERF_VIEWS}", f"--data.image_size=[{NERF_SIZE},{NERF_SIZE}]",
            f"--max_iter_run={steps}", f"--freq.scalar={NERF_SCALAR_EVERY}",
            f"--freq.val={steps // 2}", f"--freq.ckpt={steps // 2}", f"--output_root={out}"]


def scalar_file(out_dir: str, name: str) -> list:
    return [float(line.split()[1]) for line in open(f"{out_dir}/{name}.txt")]


def nerf_step_times(what: str, tcfg, images, poses, intr, state, card: str) -> dict:
    """Host ms per train step (NERF_TIMED_STEPS steps between synchronises,
    after NERF_WARMUP_STEPS), rays/s and samples/s, and the device's busy
    share of NERF_PROFILED_STEPS steps under torch.profiler; one line."""
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    step = nt.make_train_step(tcfg, images, poses, intr)
    gen = torch.Generator(device="cuda").manual_seed(11)
    n, h, w = images.shape[:3]

    def run(k, st):
        for _ in range(k):
            st, m = step(st, nt.draw_step(tcfg, n, h, w, gen, "cuda"))
        return st, m

    state, _ = run(NERF_WARMUP_STEPS, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = run(NERF_TIMED_STEPS, state)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / NERF_TIMED_STEPS
    t0 = time.perf_counter()
    run(NERF_PROFILED_STEPS, state)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    prof = profiling.device_profile(lambda: run(NERF_PROFILED_STEPS, state))
    rays = n * (tcfg.rand_rays // n)
    out = {"ms_per_step": ms, "rays_per_s": rays * 1e3 / ms,
           "samples_per_s": rays * tcfg.sample_intvs * 1e3 / ms,
           "device_ms_per_step": prof["device_ms"] / NERF_PROFILED_STEPS,
           "busy_share": prof["device_ms"] / wall_ms}
    print(f"{what}_time: {rays} rays x {tcfg.sample_intvs} samples, f32, TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}: "
          f"ms_per_step={ms:.4f} rays_per_s={out['rays_per_s']:.0f} "
          f"samples_per_s={out['samples_per_s']:.4e} "
          f"device_ms_per_step={out['device_ms_per_step']:.4f} "
          f"busy_share={out['busy_share']:.3f} loss={float(m['loss']):.5f} [{card}]", flush=True)
    print_profile(f"{what}_profile: {NERF_PROFILED_STEPS} train steps, per step", prof, card,
                  per=NERF_PROFILED_STEPS, wall_ms=wall_ms)
    return out


def phase_nerf_cli(card: str, phase: str, yaml: str, model: str, steps: int,
                   overrides: list, expect: dict, psnr_rise: float):
    """Phases 15 and 18: cli/train.main on ``yaml`` (plus ``overrides``) at
    its widths on the synthetic scene for ``steps`` steps; the NeRFTrainConfig
    must hold ``expect``; the train PSNR must rise by
    psnr_rise, the loss and params stay finite, model.ckpt restore bit for
    bit into a fresh state (restored and saved again, the same bytes) and
    transform_train.json hold the restored state's refined poses. Then the
    step's times. Returns (launch counts, times)."""
    import os
    import tempfile

    from myc_nerfs_tpu_torch.cli import train as cli_train
    from myc_nerfs_tpu_torch.core.checkpoint import restore_checkpoint, save_checkpoint
    from myc_nerfs_tpu_torch.evaluation.pose_export import load_transforms_json
    from myc_nerfs_tpu_torch.geom.conventions import unparse_camera_barf
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    with tempfile.TemporaryDirectory() as out:
        args = nerf_cli_args(yaml, model, steps, out) + overrides
        cfg = cli_train.load_run_config(args)
        tcfg = cli_train.config_to_train_config(cfg)
        if any(getattr(tcfg, k) != v for k, v in expect.items()):
            fail(f"{phase}: {yaml} did not map as expected: {tcfg}")
        reset_launches()
        t0 = time.perf_counter()
        out_dir = cli_train.main(args)
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        launches = read_launches()
        psnr = scalar_file(out_dir, "train_psnr")
        err_R = scalar_file(out_dir, "train_error_R")
        images, poses, intr, _, _ = (x.cuda() if torch.is_tensor(x) else x
                                     for x in cli_train.load_views(cfg))
        fresh = nt.init_state(tcfg, torch.Generator(device="cuda").manual_seed(9),
                              images.shape[0], "cuda")
        ckpt = os.path.join(out_dir, "model.ckpt")
        state, meta = restore_checkpoint(ckpt, fresh)
        save_checkpoint(os.path.join(out, "again.ckpt"), state, step=meta["step"])
        same = open(ckpt, "rb").read() == open(os.path.join(out, "again.ckpt"), "rb").read()
        finite = all(bool(torch.isfinite(p).all()) for p in state.params.param_list()
                     + [state.se3_refine])
        frames, _, _ = load_transforms_json(os.path.join(out_dir, "transform_train.json"))
        refined = unparse_camera_barf(nt.compose_refined_pose(tcfg, state, poses).cpu())
        pose_err = float((frames[:, :3] - refined).abs().max())
        moved = float(state.se3_refine.abs().max())
    print(f"{phase}: cli/train --model={model} --yaml={yaml} widths={tcfg.widths_feat} "
          f"skip={tcfg.skip} PE={tcfg.posenc_L3D}/{tcfg.posenc_Lview} c2f={tcfg.c2f} "
          f"noise={tcfg.camera_noise} rays={images.shape[0] * (tcfg.rand_rays // images.shape[0])} "
          f"samples={tcfg.sample_intvs} textured {NERF_VIEWS}x{NERF_SIZE}x{NERF_SIZE} "
          f"steps={steps} s={t_cli:.2f} psnr_first={psnr[0]:.3f} psnr_last={psnr[-1]:.3f} "
          f"error_R_first={err_R[0]:.5f} error_R_last={err_R[-1]:.5f} "
          f"se3_refine_max={moved:.3e} ckpt_step={meta['step']} bit_for_bit={same} "
          f"transform_train_err={pose_err:.2e} launches "
          + (" ".join(f"{k}={v}" for k, v in launches.items() if v) or "none")
          + f" [{card}]", flush=True)
    if not finite:
        fail(f"{phase}: a parameter or pose correction is not finite")
    if not psnr[-1] > psnr[0] + psnr_rise:
        fail(f"{phase}: train PSNR rose from {psnr[0]:.3f} to {psnr[-1]:.3f}")
    if not (same and meta["step"] == steps):
        fail(f"{phase}: model.ckpt did not restore bit for bit")
    if not (pose_err <= 1e-6 and frames.shape[0] == NERF_VIEWS and moved > 0):
        fail(f"{phase}: transform_train.json does not hold the refined poses ({pose_err})")
    times = nerf_step_times(phase, tcfg, images, poses, intr, state, card)
    return launches, times


def phase_garf_train(card: str):
    """Phase 15: GARF through cli/train on configs/barf/Easyship.yaml."""
    expect = dict(model="garf", widths_feat=(256,) * 6, skip=(3,), posenc_L3D=None,
                  rand_rays=2048, sample_intvs=128, camera_noise=0.06,
                  start_pose_correct_iter=0, refine_pose=True, lr=1e-4)
    return phase_nerf_cli(card, "garf_train", "configs/barf/Easyship.yaml", "garf",
                          GARF_STEPS, ["--camera.noise=0.06", "--start_pose_correct_iter=0"],
                          expect, GARF_PSNR_RISE)


def phase_barf_train(card: str):
    """Phase 18: BARF through cli/train on configs/barf/barf_blender.yaml."""
    expect = dict(model="barf", widths_feat=(256,) * 8, skip=(4,), posenc_L3D=10,
                  posenc_Lview=4, c2f=(0.1, 0.5), camera_noise=0.15, rand_rays=1024,
                  sample_intvs=128, refine_pose=True)
    return phase_nerf_cli(card, "barf_train", "configs/barf/barf_blender.yaml", "barf",
                          BARF_STEPS, [], expect, BARF_PSNR_RISE)


def phase_pose_recovery(card: str) -> None:
    """Phase 16: tests/test_barf_joint.py's protocol at GARF width on the
    card: fit the field on clean poses, then inject se(3) noise with
    refinement on and the field's rate near 0; the raw (unaligned) rotation
    and translation errors must fall below half their start."""
    from myc_nerfs_tpu_torch.data.synthetic import make_scene
    from myc_nerfs_tpu_torch.evaluation import pose_eval
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    scene = make_scene(n_views=POSE_VIEWS, H=POSE_SIZE, W=POSE_SIZE, textured=True)
    images, poses, intr = (x.cuda() for x in (scene.images, scene.poses, scene.intr))
    n = images.shape[0]
    fit = nt.NeRFTrainConfig(**POSE_ARCH, depth_range=scene.depth_range,
                             rand_rays=POSE_RAYS, sample_intvs=POSE_SAMPLES,
                             lr=POSE_FIT_LR[0], lr_end=POSE_FIT_LR[1], max_iter=POSE_FIT_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state = nt.init_state(fit, gen, n, "cuda")
    step = nt.make_train_step(fit, images, poses, intr)
    t0 = time.perf_counter()
    for _ in range(POSE_FIT_STEPS):
        state, m = step(state, nt.draw_step(fit, n, POSE_SIZE, POSE_SIZE, gen, "cuda"))
    fit_psnr = float(m["psnr"])
    refine = dataclasses.replace(fit, lr=1e-6, lr_end=1e-6, refine_pose=True,
                                 camera_noise=POSE_NOISE, lr_pose=POSE_LR[0],
                                 lr_pose_end=POSE_LR[1], max_iter=POSE_REFINE_STEPS)
    state2 = nt.init_state(refine, torch.Generator(device="cuda").manual_seed(6), n, "cuda")
    with torch.no_grad():
        for a, b in zip(state2.params.param_list(), state.params.param_list()):
            a.copy_(b)

    def raw_err(st):
        e = pose_eval.evaluate_camera_alignment(nt.compose_refined_pose(refine, st, poses),
                                                poses)
        return float(e.R.mean()), float(e.t.mean())

    r0, t0_err = raw_err(state2)
    step2 = nt.make_train_step(refine, images, poses, intr)
    for _ in range(POSE_REFINE_STEPS):
        state2, m = step2(state2, nt.draw_step(refine, n, POSE_SIZE, POSE_SIZE, gen, "cuda"))
    r1, t1 = raw_err(state2)
    torch.cuda.synchronize()
    print(f"pose_recovery: {fit.model} widths={fit.widths_feat} skip={fit.skip} textured "
          f"{POSE_VIEWS}x{POSE_SIZE}x{POSE_SIZE} rays="
          f"{n * (fit.rand_rays // n)} samples={fit.sample_intvs} fit {POSE_FIT_STEPS} steps "
          f"lr {POSE_FIT_LR[0]}->{POSE_FIT_LR[1]} psnr={fit_psnr:.3f}; noise={POSE_NOISE} "
          f"refine {POSE_REFINE_STEPS} steps lr_pose {POSE_LR[0]}->{POSE_LR[1]} field lr 1e-6: "
          f"R_err {math.degrees(r0):.4f} -> {math.degrees(r1):.4f} deg "
          f"(ratio {r1 / r0:.4f}) t_err {t0_err:.5f} -> {t1:.5f} (ratio {t1 / t0_err:.4f}) "
          f"s={time.perf_counter() - t0:.2f} [{card}]", flush=True)
    if not (r1 < 0.5 * r0 and t1 < 0.5 * t0_err):
        fail(f"pose_recovery: the raw pose errors did not halve (R {r0} -> {r1}, "
             f"t {t0_err} -> {t1})")


def nerf_gradients(tcfg, images, poses, intr, state, draws, dtype, device):
    """Every parameter's and se3_refine's gradient of make_loss on one
    batch, with the state, data and draws cast to ``dtype`` on ``device``
    (the state's modules copied)."""
    import copy

    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    cast = lambda t: None if t is None else t.to(device, dtype if t.is_floating_point()
                                                 else t.dtype)  # noqa: E731
    params = copy.deepcopy(state.params).to(device, dtype)
    se3 = cast(state.se3_refine).requires_grad_(True)
    st = state._replace(params=params, se3_refine=se3, pose_noise=cast(state.pose_noise),
                        step=state.step.to(device))
    loss_fn = nt.make_loss(tcfg, cast(images), cast(poses), cast(intr))
    loss, _ = loss_fn(st, nt.StepDraws(*(cast(d) for d in draws)))
    return torch.autograd.grad(loss, params.param_list() + [se3])


def phase_nerf_grad(card: str) -> None:
    """Phase 17: one GARF batch (Easyship.yaml, past its correction gate) and
    one BARF batch (barf_blender.yaml, c2f at progress 0.3) of NERF_GRAD_RAYS
    rays with fixed draws: every parameter's and se3_refine's gradient on the
    card (f32) against the same batch on the CPU in float64, |a-b|/|b| per
    tensor, held to NERF_GRAD_TOL; the same with TF32 turned on must exceed
    it (the check sees a silent loss of precision)."""
    from myc_nerfs_tpu_torch.cli import train as cli_train
    from myc_nerfs_tpu_torch.data.synthetic import make_scene
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    if torch.backends.cuda.matmul.allow_tf32:
        fail("nerf_grad: TF32 is on for f32 matmuls before the check")
    scene = make_scene(n_views=NERF_VIEWS, H=NERF_SIZE, W=NERF_SIZE, textured=True)
    for model, yaml, progress in (("garf", "configs/barf/Easyship.yaml", 0.4),
                                  ("barf", "configs/barf/barf_blender.yaml", 0.3)):
        cfg = cli_train.load_run_config([f"--model={model}", f"--yaml={yaml}",
                                         f"--nerf.rand_rays={NERF_GRAD_RAYS}",
                                         "--camera.noise=0.06"])
        tcfg = cli_train.config_to_train_config(cfg)
        gen = torch.Generator().manual_seed(12)
        state = nt.init_state(tcfg, gen, NERF_VIEWS, "cpu")
        step = int(progress * tcfg.max_iter)
        state = state._replace(se3_refine=0.02 * torch.randn((NERF_VIEWS, 6), generator=gen),
                               step=torch.tensor(step, dtype=torch.int32))
        draws = nt.draw_step(tcfg, NERF_VIEWS, NERF_SIZE, NERF_SIZE, gen)
        data = (scene.images, scene.poses, scene.intr)
        ref = nerf_gradients(tcfg, *data, state, draws, torch.float64, "cpu")
        t0 = time.perf_counter()
        card_grads = nerf_gradients(tcfg, *data, state, draws, torch.float32, "cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = nerf_gradients(tcfg, *data, state, draws, torch.float32, "cuda")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tol = NERF_GRAD_TOL[model]
        errs = [rel(a.double().cpu(), b) for a, b in zip(card_grads, ref)]
        tf32_errs = [rel(a.double().cpu(), b) for a, b in zip(tf32, ref)]
        print(f"nerf_grad: {model} {yaml} widths={tcfg.widths_feat} step={step} "
              f"(progress {step / tcfg.max_iter:.2f}) {NERF_VIEWS * (tcfg.rand_rays // NERF_VIEWS)}"
              f" rays x {tcfg.sample_intvs} samples, card f32 vs CPU f64 |a-b|/|b|: "
              f"params max={max(errs[:-1]):.3e} se3_refine={errs[-1]:.3e} "
              f"limit={tol:.1e}; TF32 on: params max={max(tf32_errs[:-1]):.3e} "
              f"se3_refine={tf32_errs[-1]:.3e} (sees={max(tf32_errs) > tol}) "
              f"card_s={t_card:.2f} [{card}]", flush=True)
        if not max(errs) <= tol:
            fail(f"nerf_grad: {model} card gradient differs from the f64 one by {max(errs)}")
        if not max(tf32_errs) > tol:
            fail(f"nerf_grad: the {model} check does not see TF32 ({max(tf32_errs)})")


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
    """Where the time goes, after every counted and timed run: one 800x800
    frame (the slice's model, built again) and one train block of
    update_den_freq steps at 4096 rays (the trained model) under
    torch.profiler, each also timed without it, for the device's busy
    share of the wall time; then the wide fused-MLP
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


# -- phases 19-21: TensoRF -----------------------------------------------------


def tensorf_txt(src: str, out: str, overrides: dict) -> str:
    """A copy of the config ``src`` in ``out`` with the keys of ``overrides``
    set (replaced where the file has them, appended otherwise)."""
    import os

    lines, seen = [], set()
    for line in open(src):
        body = line.split("#", 1)[0]
        key = body.split("=", 1)[0].strip()
        if "=" in body and key in overrides:
            lines.append(f"{key} = {overrides[key]}\n")
            seen.add(key)
        else:
            lines.append(line)
    lines += [f"{k} = {v}\n" for k, v in overrides.items() if k not in seen]
    path = os.path.join(out, os.path.basename(src))
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def tensorf_synthetic(out: str, steps: int, events: dict) -> dict:
    """The overrides that put a TensoRF config on the synthetic scene: the
    textured field (with --textured), TENSORF_VIEWS views at TENSORF_SIZE^2,
    demo_synthetic.txt's bbox / near / far, ``steps`` iterations, the
    events ``events`` and the output under ``out``."""
    return {"synthetic": True, "synthetic_size": TENSORF_SIZE,
            "synthetic_views": TENSORF_VIEWS, "bbox": [-1.2] * 3 + [1.2] * 3, "near": 1.5,
            "far": 4.5, "n_iters": steps, "basedir": out, **events}


def tensorf_cli(argv: list) -> tuple:
    """cli/tensorf_train.main(argv) with its stdout captured: (out_dir, the
    (N, X) of its "iter N psnr X" lines, the launch counts, seconds)."""
    import contextlib
    import io

    from myc_nerfs_tpu_torch.cli import tensorf_train as tcli

    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out_dir = tcli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    psnr = [(int(line.split()[1]), float(line.split()[3]))
            for line in buf.getvalue().splitlines() if line.startswith("iter ")]
    return out_dir, psnr, launches, seconds


def launch_text(launches: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in launches.items() if v) or "none"


def phase_tensorf_train(card: str):
    """Phase 19: cli/tensorf_train.main on configs/tensorf/Coffee.txt at its
    widths (VM-split 16x3 / 48x3, app_dim 27, MLP_Fea 128 wide with PE 2/2,
    softplus, 2097156 -> 27e6 voxels, 4096 rays, step_ratio 0.5, TV 0.3 /
    0.3, L1 4e-5 / 2e-5, rm_weight_mask_thre 1e-3), from a temporary copy
    with these cuts: the textured synthetic scene (TENSORF_VIEWS views at
    TENSORF_SIZE^2; no Coffee images here), demo_synthetic.txt's bbox ([-1.2,
    1.2]^3), near 1.5 and far 4.5, and the events and n_iters divided by
    10 (upsamples at 200, 300, 400, 550, 700; alpha masks at 200 and 400;
    800 steps): every event runs once. The train PSNR must rise by
    TENSORF_PSNR_RISE, the params stay finite, the final grid be
    n_to_reso(27e6, the shrunk aabb), the checkpoint restore bit for bit
    into a fresh trainer (restored, saved again: the same bytes); then
    --render_only renders the scene's views with PSNR and SSIM and
    --export_mesh writes a .ply with faces. Returns the launch counts."""
    import os
    import tempfile

    from myc_nerfs_tpu_torch.cli import tensorf_train as tcli
    from myc_nerfs_tpu_torch.core.checkpoint import read_tensorf_checkpoint
    from myc_nerfs_tpu_torch.train import tensorf_trainer as ttt

    with tempfile.TemporaryDirectory() as out:
        events = {"upsamp_list": [200, 300, 400, 550, 700], "update_AlphaMask_list": [200, 400]}
        cfg = tensorf_txt("configs/tensorf/Coffee.txt", out,
                          tensorf_synthetic(out, TENSORF_STEPS, events))
        a = tcli.parse_txt_config(cfg)
        model_cfg, train_cfg = tcli.build_configs(a)
        expect = dict(decomp="vm_split", density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48),
                      app_dim=27, shading_mode="MLP_Fea", featureC=128, view_pe=2, fea_pe=2,
                      fea2dense="softplus", step_ratio=0.5, ray_march_weight_thres=1e-3)
        expect_t = dict(batch_size=4096, n_voxel_init=2097156, n_voxel_final=27000000,
                        tv_weight_density=0.3, tv_weight_app=0.3, l1_weight_initial=4e-5,
                        l1_weight_rest=2e-5)
        if any(getattr(model_cfg, k) != v for k, v in expect.items()) or \
                any(getattr(train_cfg, k) != v for k, v in expect_t.items()):
            fail(f"tensorf_train: Coffee.txt did not map as expected: {model_cfg} {train_cfg}")
        argv = ["--config", cfg, "--textured", "--log_every", str(TENSORF_LOG_EVERY)]
        out_dir, log, launches, seconds = tensorf_cli(argv)
        psnr = [p for _, p in log]
        ckpt = os.path.join(out_dir, "Coffee.ckpt")
        tree, meta = read_tensorf_checkpoint(ckpt)
        finite = all(np.isfinite(v).all() for _, v in flat_tree(tree["params"]))
        aabb = np.asarray(tree["aabb"], np.float64)
        want_grid = ttt.n_to_reso(train_cfg.n_voxel_final, aabb)
        trainer = tcli.build_family_trainer(a, model_cfg, train_cfg, np.asarray(a["bbox"],
                                            np.float32).reshape(2, 3),
                                            torch.Generator(device="cuda").manual_seed(5), "cuda")
        tcli.restore_tensorf_ckpt(ckpt, trainer, for_training=True)
        again = os.path.join(out, "again.ckpt")
        tcli.save_tensorf_ckpt(again, trainer, "TensorVMSplit")
        same = open(ckpt, "rb").read() == open(again, "rb").read()
        t0 = time.perf_counter()
        tcli.main(argv + ["--render_only", "1"])
        t_render = time.perf_counter() - t0
        mean = dict(line.split() for line in open(os.path.join(out_dir, "imgs_test_all",
                                                               "mean.txt")))
        t0 = time.perf_counter()
        tcli.main(argv + ["--export_mesh", "1"])
        t_mesh = time.perf_counter() - t0
        ply = open(os.path.join(out_dir, "Coffee.ply")).read().splitlines()
        n_faces = int(ply[6].split()[-1])
    print(f"tensorf_train: cli/tensorf_train --config Coffee.txt (VM-split 16x3/48x3, app_dim 27, "
          f"MLP_Fea 128, 4096 rays, step_ratio 0.5) textured {TENSORF_VIEWS}x{TENSORF_SIZE}x"
          f"{TENSORF_SIZE} steps={meta['global_step']} s={seconds:.2f} psnr_first={psnr[0]:.3f} "
          f"psnr_last={psnr[-1]:.3f} grid={meta['grid_size']} (n_to_reso(27e6)={want_grid}) "
          f"aabb={np.round(aabb, 4).tolist()} alpha_volume={list(np.shape(tree['alpha_volume']))} "
          f"bit_for_bit={same} render: psnr={float(mean['psnr']):.3f} "
          f"ssim={float(mean['ssim']):.4f} s={t_render:.2f} mesh: faces={n_faces} "
          f"s={t_mesh:.2f} launches {launch_text(launches)} [{card}]", flush=True)
    if not finite:
        fail("tensorf_train: a parameter is not finite")
    if not psnr[-1] > psnr[0] + TENSORF_PSNR_RISE:
        fail(f"tensorf_train: train PSNR rose from {psnr[0]:.3f} to {psnr[-1]:.3f}")
    if list(meta["grid_size"]) != want_grid or not (aabb[1] - aabb[0] < 2.4).any():
        fail(f"tensorf_train: final grid {meta['grid_size']} on aabb {aabb} is not "
             f"n_to_reso(27e6) of a shrunk aabb ({want_grid})")
    if not same:
        fail("tensorf_train: the checkpoint did not restore bit for bit")
    if not (np.isfinite(float(mean["psnr"])) and 0 < float(mean["ssim"]) <= 1 and n_faces > 0):
        fail(f"tensorf_train: render {mean} or mesh ({n_faces} faces) failed")
    return launches


def flat_tree(tree, prefix=()):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_tree(v, prefix + (k,))
    else:
        yield prefix, tree


def ball_rays(n_batches: int, batch: int, gen: torch.Generator):
    """bench.py::measure_tensorf_train's rays: origins uniform in angle on
    the sphere of radius 3, looking at the centre; random colours."""
    theta = torch.rand(n_batches * batch, device="cuda", generator=gen) * 6.28318
    phi = torch.rand(n_batches * batch, device="cuda", generator=gen) * 3.14159
    o = torch.stack([3.0 * torch.cos(theta) * torch.sin(phi),
                     3.0 * torch.sin(theta) * torch.sin(phi), 3.0 * torch.cos(phi)], -1)
    d = -o / torch.linalg.norm(o, dim=-1, keepdim=True)
    rays = torch.cat([o, d], -1).reshape(n_batches, batch, 6)
    return rays, torch.rand((n_batches, batch, 3), device="cuda", generator=gen)


def op_groups(prof: dict) -> dict:
    """The profile's device ms by kind: grid_sample forward and backward,
    GEMMs, index / scatter / gather, reductions and the rest (elementwise)."""
    groups = {"grid_sample_fwd": 0.0, "grid_sample_bwd": 0.0, "gemm": 0.0, "index": 0.0,
              "reduce": 0.0, "copy": 0.0, "elementwise": 0.0}
    for name, (ms, _) in prof["by_name"].items():
        low = name.lower()
        if "grid_sampler" in low:
            groups["grid_sample_bwd" if "backward" in low else "grid_sample_fwd"] += ms
        elif any(k in low for k in ("gemm", "xmma", "cutlass", "sm90", "ampere_s", "cublas")):
            groups["gemm"] += ms
        elif any(k in low for k in ("index", "scatter", "gather", "nonzero", "masked")):
            groups["index"] += ms
        elif "reduce" in low:
            groups["reduce"] += ms
        elif "memcpy" in low or "memset" in low or "copy" in low:
            groups["copy"] += ms
        else:
            groups["elementwise"] += ms
    return groups


def sync_sites(fn) -> list:
    """The host syncs of one fn(), as "file:line" of the Python call that
    made each (torch.cuda's sync debug mode warns once per synchronising
    call)."""
    import os
    import traceback
    import warnings

    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            frames = [f for f in stack if "myc_nerfs_tpu_torch" in f.filename] or \
                [f for f in stack if "warnings" not in f.filename][-2:]
            if frames[-1].name != "set_sync_debug_mode":  # the harness's own, once
                sites.append(f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno}"
                             f"({frames[-1].name})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def phase_tensorf_step(card: str) -> dict:
    """Phase 20: the TensoRF train step at Coffee's hardest stage, the shape
    of bench.py::measure_tensorf_train: VM-split at 300^3 (Coffee's widths,
    random weights and a centred density bump, tensorf_bump, so that a
    trained scene's share of samples passes the appearance threshold; at
    bench.py's random init almost none does), 4096 rays from a sphere of
    radius 3 at the centre,
    step_ratio 0.5 (1036 samples per ray), TV 0.3 / 0.3 and L1 4e-5; first
    with a 256^3 ball alpha mask (r < 0.35 of the box), corner-dilated,
    then with no mask (the stage before the first mask update). For each:
    ms per step on the host clock (TENSORF_STEP_TIMED steps after
    TENSORF_STEP_WARMUP, the batches cycling through 16), rays/s, samples/s
    (the ray's samples) and the samples that pass the gate and the
    appearance threshold, the host syncs of one step, peak device memory,
    and the device time, busy share, top device operations and the
    split by kind of TENSORF_STEP_PROFILED steps under torch.profiler.
    Returns the launch counts of the timed steps."""
    from myc_nerfs_tpu_torch.models import tensorf as tfm
    from myc_nerfs_tpu_torch.train import tensorf_trainer as ttt

    mcfg = tfm.TensoRFConfig(decomp="vm_split", step_ratio=0.5)
    cfg = ttt.TensoRFTrainConfig(n_voxel_init=300 ** 3, batch_size=4096, tv_weight_density=0.3,
                                 tv_weight_app=0.3, l1_weight_initial=4e-5,
                                 l1_weight_rest=2e-5)
    aabb = np.array([[-1.2] * 3, [1.2] * 3], np.float32)
    gen = torch.Generator(device="cuda").manual_seed(20)
    trainer = ttt.TensoRFTrainer(mcfg, cfg, aabb, gen, "cuda")
    # n_to_reso(300^3) of this box reads 299 a side (f64 rounding of the
    # voxel size), as in bench.py; the stage is set to 300^3 itself
    trainer.params = tfm.upsample_volume_grid(mcfg, trainer.params, (300, 300, 300))
    trainer.geom = tfm.compute_stage_geom(mcfg, aabb, (300, 300, 300))
    tensorf_bump(trainer.params)
    if trainer.geom.n_samples != 1036 or trainer.geom.grid_size != (300, 300, 300):
        fail(f"tensorf_step: the stage is {trainer.geom}, not 300^3 x 1036 samples")
    rays, rgbs = ball_rays(16, cfg.batch_size, gen)
    reso = 256
    g = (torch.arange(reso, device="cuda") + 0.5) / reso - 0.5
    r = torch.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2)
    ball = (r < 0.35).float()
    counter = [0]

    def step():
        i = counter[0] % rays.shape[0]
        counter[0] += 1
        return trainer.train_step(rays[i], rgbs[i], trainer.draw_fn(trainer, cfg.batch_size, gen))

    def run(k):
        for _ in range(k):
            m = step()
        return m

    out = {}
    launches = None
    for stage, vol in (("masked", ball), ("premask", None)):
        trainer.buffers = tfm.prepare_alpha_buffers({**trainer.buffers, "alpha_volume": vol,
                                                     "alpha_aabb": trainer.buffers["aabb"]})
        trainer._rebuild(1.0)
        run(TENSORF_STEP_WARMUP)
        with torch.no_grad():
            fwd = trainer.forward(trainer.params, rays[0],
                                  trainer.draw_fn(trainer, cfg.batch_size, gen))
            n_density = int(fwd.extras["valid"].sum())
            n_app = int(fwd.extras["app_mask"].sum())
        sites = sync_sites(step)
        syncs = len(sites)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if stage == "masked":
            reset_launches()
        t0 = time.perf_counter()
        m = run(TENSORF_STEP_TIMED)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TENSORF_STEP_TIMED
        if stage == "masked":
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        run(TENSORF_STEP_PROFILED)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof = profiling.device_profile(lambda: run(TENSORF_STEP_PROFILED))
        n_samples = cfg.batch_size * trainer.geom.n_samples
        groups = op_groups(prof)
        out[stage] = {"ms_per_step": ms, "rays_per_s": cfg.batch_size * 1e3 / ms,
                      "samples_per_s": n_samples * 1e3 / ms,
                      "device_ms_per_step": prof["device_ms"] / TENSORF_STEP_PROFILED,
                      "busy_share": prof["device_ms"] / wall_ms, "peak_gib": peak,
                      "syncs": syncs, "density_samples": n_density, "app_samples": n_app}
        print(f"tensorf_step: {stage} VM-split 300^3 (16x3/48x3, app_dim 27, MLP_Fea 128) "
              f"{cfg.batch_size} rays x {trainer.geom.n_samples} samples, f32, TF32 "
              f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}"
              f"{', 256^3 ball alpha mask (dilated)' if vol is not None else ', no alpha mask'}: "
              f"ms_per_step={ms:.4f} rays_per_s={out[stage]['rays_per_s']:.0f} "
              f"samples_per_s={out[stage]['samples_per_s']:.4e} density_samples={n_density} "
              f"app_samples={n_app} syncs_per_step={syncs} ({','.join(sites)}) "
              f"peak_gib={peak:.3f} "
              f"device_ms_per_step={out[stage]['device_ms_per_step']:.4f} "
              f"busy_share={out[stage]['busy_share']:.3f} mse={float(m['mse']):.5f} "
              f"split_ms_per_step " + " ".join(f"{k}={v / TENSORF_STEP_PROFILED:.4f}"
                                               for k, v in groups.items())
              + f" [{card}]", flush=True)
        print_profile(f"tensorf_step_profile: {stage}, {TENSORF_STEP_PROFILED} steps, per step",
                      prof, card, per=TENSORF_STEP_PROFILED, wall_ms=wall_ms)
    return launches


def tensorf_bump(params) -> None:
    """A centred density bump (planes + 0.25 gauss, lines + 1, in place):
    density where a scene's object is, so weights pass the appearance
    threshold at a random init."""
    with torch.no_grad():
        for pl in params["density_plane"]:
            C, H, W = pl.shape
            v, u = torch.meshgrid(torch.linspace(-1, 1, H, device=pl.device),
                                  torch.linspace(-1, 1, W, device=pl.device), indexing="ij")
            pl += 0.25 * torch.exp(-(u ** 2 + v ** 2) / 0.2)
        for line in params["density_line"]:
            line += 1.0


def params_as(params, device, dtype):
    """A copy of TensoRF params (factor tensors and modules) on ``device``
    in ``dtype``, leaves requiring grad."""
    import copy

    out = {}
    for k, v in params.items():
        if isinstance(v, torch.nn.Module):
            out[k] = copy.deepcopy(v).to(device, dtype)
        elif isinstance(v, (list, tuple)):
            out[k] = [t.detach().to(device, dtype).requires_grad_(True) for t in v]
        else:
            out[k] = v.detach().to(device, dtype).requires_grad_(True)
    return out


def tensorf_gradients(trainer, rays, rgbs, draws, device, dtype) -> tuple:
    """Every parameter's gradient of the trainer's loss on one batch, with
    params, buffers, data and draws cast to ``dtype`` on ``device``; and
    the batch's valid and appearance masks."""
    from myc_nerfs_tpu_torch.models import tensorf as tfm
    from myc_nerfs_tpu_torch.train import tensorf_trainer as ttt

    cast = lambda t: t.to(device, dtype if t.is_floating_point() else t.dtype)  # noqa: E731
    params = params_as(trainer.params, device, dtype)
    bufs = {k: None if v is None else cast(v) for k, v in trainer.buffers.items()}
    d = tuple(cast(x) for x in draws) if isinstance(draws, tuple) else cast(draws)
    mc, geom, wb = trainer.model_cfg, trainer.geom, trainer.cfg.white_bg
    fwd = lambda p, r, dr: trainer.forward_fn(mc, geom, p, bufs, r, dr, wb)  # noqa: E731
    step = torch.tensor(trainer.global_step, dtype=torch.int32, device=device)
    total, _, out = ttt.tensorf_loss(mc, trainer.cfg, fwd, trainer.extra_loss_fn,
                                     trainer.lr_factor, params, cast(rays), cast(rgbs), d, step)
    leaves = [t for _, t in tfm.param_items(params)]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return grads, out.extras["valid"].cpu(), out.extras["app_mask"].cpu()


def phase_tensorf_variants(card: str) -> list:
    """Phase 21: phase 19's treatment of configs/tensorf/Scar.txt
    (REFTensoRF, normal penalty 0.5, TV 2.0, rm_weight_mask_thre 1e-6; its
    events are Coffee's: divided by 10, 800 steps) and Scarf.txt
    (NerfPlusPlus: bg_D 3, bg_freq 2, radii 28, 512 bg samples, 1024 rays;
    events divided by 100: 80 and 160, 256 steps): the train PSNR must rise
    by TENSORF_VARIANT_PSNR_RISE before the first mask update, and stay
    finite. At Scar's settings on this scene the first mask update
    collapses the field: TV 2.0 spreads the density thin,
    rm_weight_mask_thre 1e-6 lets thin density carry colour, and the mask
    keeps alpha >= 1e-3 over one step without distance_scale (sigma >=
    0.106), which cuts the thin density that renders the object; the PSNR
    falls to the background's. The events are the JAX package's (the
    staged parity test), and with TV 0.3, rm_weight_mask_thre 1e-3 or no
    mask update the same cut does not collapse. So the rise is read up to
    the last line before the first mask update, and the whole trajectory
    is printed. Then one batch (TENSORF_GRAD_RAYS rays of the synthetic
    scene, fixed draws) of each family (VM-split on Coffee.txt, REF,
    NeRF++) at 48^3 voxels with a centred density bump: every parameter's
    gradient on the card in f32 (TF32 off) against the CPU in f64, |a-b| /
    |b| per tensor within TENSORF_GRAD_TOL. Returns the launch counts of
    the two training runs.

    Scarf at its published widths (its bbox, near 15, radii 28, the final
    stage's (428, 147, 428) grid and 1241 foreground samples, 512
    background samples, 1024 rays, past both events) is the benchmark's
    cell tensorf_scarf.train, checked there against a plain reference on
    the card each run. What only this phase covers: Scarf's events (the
    alpha-mask updates, the shrink, both upsamples, the ray refilter) and
    training over many steps until the PSNR rises, the REF family, and the
    f32 card gradients against f64."""
    import tempfile

    from myc_nerfs_tpu_torch.cli import tensorf_train as tcli

    runs = []
    with tempfile.TemporaryDirectory() as out:
        for src, name, events, expect in (
                ("configs/tensorf/Scar.txt", "REFTensoRF",
                 {"upsamp_list": [200, 300, 400, 550, 700], "update_AlphaMask_list": [200, 400]},
                 {"normal_vector_penalty_weight": 0.5}),
                ("configs/tensorf/Scarf.txt", "NerfPlusPlus",
                 {"upsamp_list": [80, 160], "update_AlphaMask_list": [80, 160]},
                 {"bg_D": 3, "bg_freq": 2, "radii": 28, "batch_size": 1024})):
            steps = TENSORF_VARIANT_STEPS[name]
            cfg = tensorf_txt(src, out, tensorf_synthetic(out, steps, events))
            a = tcli.parse_txt_config(cfg)
            if a["model_name"] != name or any(a[k] != v for k, v in expect.items()):
                fail(f"tensorf_variants: {src} did not map as expected: {a}")
            out_dir, log, launches, seconds = tensorf_cli(
                ["--config", cfg, "--textured", "--log_every", str(TENSORF_VARIANT_LOG_EVERY)])
            runs.append(launches)
            psnr = [p for _, p in log]
            first_mask = events["update_AlphaMask_list"][0]
            pre = [p for it, p in log if it < first_mask][-1]
            print(f"tensorf_variants: cli/tensorf_train --config {src} ({name}) textured "
                  f"{TENSORF_VIEWS}x{TENSORF_SIZE}x{TENSORF_SIZE} steps={steps} "
                  f"rays={a['batch_size']} s={seconds:.2f} psnr_first={psnr[0]:.3f} "
                  f"psnr_before_first_mask={pre:.3f} psnr_last={psnr[-1]:.3f} "
                  f"psnr_every_{TENSORF_VARIANT_LOG_EVERY}={[round(p, 2) for p in psnr]} "
                  f"launches {launch_text(launches)} [{card}]", flush=True)
            if not (pre > psnr[0] + TENSORF_VARIANT_PSNR_RISE[name]
                    and all(np.isfinite(psnr))):
                fail(f"tensorf_variants: {name} train PSNR rose from {psnr[0]:.3f} to "
                     f"{pre:.3f} before the first mask update (last {psnr[-1]:.3f})")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("tensorf_variants: TF32 is on for f32 matmuls before the gradient check")
    for src in ("configs/tensorf/Coffee.txt", "configs/tensorf/Scar.txt",
                "configs/tensorf/Scarf.txt"):
        a = tcli.parse_txt_config(src)
        a.update(synthetic=True, synthetic_size=TENSORF_SIZE, synthetic_views=TENSORF_VIEWS,
                 N_voxel_init=48 ** 3, bbox=[-1.2] * 3 + [1.2] * 3, near=1.5, far=4.5)
        model_cfg, train_cfg = tcli.build_configs(a)
        rays, rgbs, aabb, _ = tcli.load_rays(a, "cpu", textured=True)
        gen = torch.Generator().manual_seed(21)
        trainer = tcli.build_family_trainer(a, model_cfg, train_cfg, aabb, gen, "cpu")
        tensorf_bump(trainer.params)
        ids = torch.randint(0, rays.shape[0], (TENSORF_GRAD_RAYS,), generator=gen)
        draws = trainer.draw_fn(trainer, TENSORF_GRAD_RAYS, gen)
        batch = (rays[ids], rgbs[ids], draws)
        ref, valid64, app64 = tensorf_gradients(trainer, *batch, "cpu", torch.float64)
        t0 = time.perf_counter()
        grads, valid32, app32 = tensorf_gradients(trainer, *batch, "cuda", torch.float32)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        errs = [rel(g.double().cpu(), r) for g, r in zip(grads, ref)]
        tol = TENSORF_GRAD_TOL
        print(f"tensorf_grad: {a['model_name']} {src} grid={trainer.geom.grid_size} "
              f"{TENSORF_GRAD_RAYS} rays x {trainer.geom.n_samples} samples, app samples "
              f"{int(app64.sum())} (f64) / {int(app32.sum())} (card f32), valid differing "
              f"{int((valid64 != valid32).sum())}, app differing {int((app64 != app32).sum())}; "
              f"card f32 vs CPU f64 |a-b|/|b| over {len(errs)} tensors: max={max(errs):.3e} "
              f"median={float(np.median(errs)):.3e} limit={tol:.1e} card_s={t_card:.2f} "
              f"[{card}]", flush=True)
        if not max(errs) <= tol:
            fail(f"tensorf_grad: {a['model_name']} card gradient differs from the f64 one by "
                 f"{max(errs)}")
    return runs



# phases 22-25 (the evaluation and pose-chain slice). Phase 22: the GARF run
# evaluated (cli/train then cli/evaluate at Easyship.yaml's widths), views
# from EVAL_START on, test-time optimisation at optim.test_iter
# EVAL_TEST_ITER (at most 100 iterations per view)
EVAL_STEPS, EVAL_START, EVAL_TEST_ITER = 256, 9, 1
# phase 23: cli/pose_chain at L16F2 width with these cuts of its budget
# (the reference scale: GARF 50000, NGP 6000 per leg, 256^2, 36 views, tt
# 1500); then, on one view of the gt leg, d loss / d se3 through the
# kernels against the plain versions (fused_mlp_plain's reference MLP,
# paired_encode_reference, march_rays_fused_plain, composite_marched_plain),
# |a - b| / |b| within CHAIN_GRAD_TOL: the two
# differ by the bf16 MLPs' rounding in another order
CHAIN_ARGV = ["--garf_steps", "512", "--ngp_steps", "256", "--size", "128", "--views", "12",
              "--tt_iters", "100", "--log_every", "256"]
CHAIN_GRAD_TOL = 2.0 ** -5
# phase 24: cli/tensorf_budget on Coffee.txt at 128^2, 12 views (0, 4, 8
# held out), BUDGET_STEPS steps in chunks of BUDGET_STEPS // 2. The split
# run (--stop_at, --resume) is held against the straight run within
# BUDGET_SPLIT_FACTOR times the spread of two straight runs (the
# grid_sample backward's atomics add in no fixed order), and bit for bit
# where the two straight runs agree bit for bit
BUDGET_STEPS, BUDGET_SPLIT_FACTOR = 200, 4.0
# phase 25: entry()'s render through the kernels against the plain versions
ENTRY_TOL = 1e-4


def ansi_free(text: str) -> str:
    import re

    return re.sub(r"\x1b\[[0-9;]*m", "", text)


def phase_evaluate(card: str):
    """Phase 22: a GARF run of cli/train (EVAL_STEPS steps on phase 15's
    scene and config) evaluated by cli/evaluate with optim.test_photo from
    view EVAL_START: every output file must exist (quant_pose.txt,
    transform_train.json, quant.txt, loss.txt, transform_val.json, each
    view's rgb_<i>.npy) and the poses be finite; one line with each view's
    PSNR, test-time iterations, stop reason and ms per iteration. Returns
    the launch counts (GARF runs no kernel)."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    from myc_nerfs_tpu_torch.cli import evaluate as cli_eval
    from myc_nerfs_tpu_torch.cli import train as cli_train
    from myc_nerfs_tpu_torch.evaluation.pose_export import load_transforms_json

    with tempfile.TemporaryDirectory() as out:
        args = nerf_cli_args("configs/barf/Easyship.yaml", "garf", EVAL_STEPS, out) + [
            "--camera.noise=0.06", "--start_pose_correct_iter=0"]
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_train.main(args)
        t_train = time.perf_counter() - t0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out_dir = cli_eval.main(args + ["--optim.test_photo",
                                            f"--optim.test_iter={EVAL_TEST_ITER}",
                                            f"--start={EVAL_START}"])
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        launches = read_launches()
        views = list(range(EVAL_START, NERF_VIEWS))
        names = (["quant_pose.txt", "transform_train.json", "quant.txt", "loss.txt",
                  "transform_val.json"] + [f"rgb_{i}.npy" for i in views])
        missing = [n for n in names if not os.path.exists(os.path.join(out_dir, n))]
        finite = not missing and all(
            bool(torch.isfinite(load_transforms_json(os.path.join(out_dir, n))[0]).all())
            for n in ("transform_train.json", "transform_val.json"))
        psnr = {} if missing else {int(a): float(b) for a, b in (
            line.split() for line in open(os.path.join(out_dir, "quant.txt")))}
        rot = [] if missing else [float(line.split()[1])
                                  for line in open(os.path.join(out_dir, "quant_pose.txt"))]
    tt = re.findall(r"view (\d+): test-time optimisation (\d+) iterations \((\w+)\), "
                    r"loss ([0-9.e+-]+), ([0-9.]+) ms per iteration", ansi_free(buf.getvalue()))
    per_view = " ".join(f"view{v}:psnr={psnr.get(int(v), float('nan')):.3f},tt_iters={n},"
                        f"stop={r},tt_loss={float(l):.6f},ms_per_tt_iter={float(m):.3f}"
                        for v, n, r, l, m in tt)
    print(f"evaluate: cli/train --model=garf Easyship.yaml {EVAL_STEPS} steps ({t_train:.2f} s), "
          f"cli/evaluate --optim.test_photo --optim.test_iter={EVAL_TEST_ITER} "
          f"--start={EVAL_START} ({t_eval:.2f} s): mean rot err {np.rad2deg(np.mean(rot)) if rot else float('nan'):.3f} deg, "
          f"{per_view} missing={missing or 'none'} poses_finite={finite} [{card}]", flush=True)
    if missing or not finite:
        fail(f"evaluate: outputs missing ({missing}) or poses not finite")
    if len(tt) != len(views) or not all(np.isfinite(list(psnr.values()))):
        fail(f"evaluate: {len(tt)} test-time runs for {len(views)} views, or a PSNR not finite")
    return launches


def chain_pose_gradient(trainer, scene, vi: int, n_rays: int, kernels: bool):
    """d loss / d se3 of cli/pose_chain's test-time loss at se3 = 0 on view
    vi, through the kernels or through the plain versions, and the kernel
    launches it made."""
    from unittest import mock

    from myc_nerfs_tpu_torch.cli import pose_chain as pc
    from myc_nerfs_tpu_torch.evaluation.test_time_optim import make_ngp_pose_loss
    from myc_nerfs_tpu_torch.render import ngp_render as nr

    model = trainer.model
    model.use_encode_kernel = kernels
    model.net.use_fully = kernels
    march = nr.march_rays_fused if kernels else nr.march_rays_fused_plain
    composite = nr.composite_marched if kernels else nr.composite_marched_plain
    reset_launches()
    try:
        with mock.patch.object(nr, "march_rays_fused", march), \
                mock.patch.object(nr, "composite_marched", composite):
            loss_fn = make_ngp_pose_loss(trainer.occ_cfg, trainer.rcfg, model, trainer.state.occ,
                                         scene.poses[vi].cuda(), scene.intr[vi].cuda(),
                                         scene.images[vi].cuda(), scene.H, scene.W,
                                         world_scale=pc.SCALE, world_offset=pc.OFF,
                                         bg=torch.ones(3, device="cuda"),
                                         density_apply=model.density_raw)
            idx = torch.randint(0, scene.H * scene.W, (n_rays,), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(vi))
            x = torch.zeros((1, 6), device="cuda", requires_grad=True)
            loss = loss_fn(x, idx)
            (g,) = torch.autograd.grad(loss, x)
    finally:
        model.use_encode_kernel = True
        model.net.use_fully = True
    return float(loss), g, read_launches()


def phase_pose_chain(card: str):
    """Phase 23: cli/pose_chain (the slice's main path) at L16F2 width, cut
    to CHAIN_ARGV: noisy cameras, GARF, the sim3 val-pose transfer, the
    three NGP legs (brick3 L16F2, bf16, fused march, 8192 rays) and the
    per-view test-time optimisation. Each leg's train PSNR must rise, its
    PSNRs be finite, and the four NGP kernels run. Then d loss / d se3 of
    the gt leg's view 0 through the kernels against the plain versions
    (CHAIN_GRAD_TOL), and the cost of test-time optimisation's backward
    kernel: fused_mlp_backward (need_dx, frozen weights: its dW is
    discarded) at the loss's rgb-MLP rows, beside the forward kernel and the
    iteration. Returns the launch counts."""
    import contextlib
    import io
    import tempfile

    from myc_nerfs_tpu_torch.cli import pose_chain as pc
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    with tempfile.TemporaryDirectory() as out:
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = pc.main(CHAIN_ARGV + ["--out_dir", out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    garf, legs = res["garf"], res["legs"]
    print(f"pose_chain: cli/pose_chain {' '.join(CHAIN_ARGV)} (cuts of 50000 / 6000 / 256^2 / "
          f"36 views / tt 1500), L16F2 brick3 bf16, 8192 rays: s={seconds:.2f} GARF "
          f"rot {garf['rot_err_deg_init']:.3f} -> {garf['rot_err_deg']:.3f} deg (ratio "
          f"{garf['rot_ratio']:.4f}), trans {garf['trans_err_init']:.4f} -> "
          f"{garf['trans_err']:.4f} (ratio {garf['trans_ratio']:.4f}), "
          f"{garf['wall_s'] / garf['steps'] * 1e3:.2f} ms per step; launches {launch_text(launches)} "
          f"[{card}]", flush=True)
    for tag, leg in legs.items():
        tt = " ".join(f"{t['iters']}/{t['reason']}/{t['ms_per_iter']:.3f}ms" for t in leg["tt"])
        print(f"pose_chain_ngp: {tag}: train_psnr {leg['train_psnr_first']:.3f} -> "
              f"{leg['train_psnr']:.3f}, val_psnr {leg['val_psnr']:.3f} "
              f"({' '.join(f'{p:.3f}' for p in leg['val_psnrs'])}), after tt "
              f"{leg['val_psnr_tt']:.3f} ({' '.join(f'{p:.3f}' for p in leg['val_psnrs_tt'])}), "
              f"tt iters/stop/ms per iter: {tt}, krays_s={leg['krays_s']:.1f}, "
              f"train launches {launch_text(leg['train_launches'])}, eval launches "
              f"{launch_text(leg['eval_launches'])} [{card}]", flush=True)
    bad = [tag for tag, leg in legs.items()
           if not leg["train_psnr"] > leg["train_psnr_first"]
           or not np.isfinite(leg["val_psnrs"] + leg["val_psnrs_tt"]).all()]
    if set(legs) != set(pc.LEGS) or bad:
        fail(f"pose_chain: a leg is missing or its train PSNR did not rise: {bad}")
    if not all(launches[k] > 0 for k in TRAIN_KERNELS + ("march_rays_fused",
                                                          "march_rays_fused_bwd")):
        fail(f"pose_chain: an NGP kernel did not run: {launches}")
    trainer, scene = legs["gt"]["trainer"], res["scene"]
    n_rays = pc.parse_args(CHAIN_ARGV).tt_rays
    l_k, g_k, n_k = chain_pose_gradient(trainer, scene, 0, n_rays, kernels=True)
    l_p, g_p, n_p = chain_pose_gradient(trainer, scene, 0, n_rays, kernels=False)
    err = float((g_k - g_p).norm() / g_p.norm())
    pair = ("ngp_composite", "ngp_composite_bwd")
    if [n_k[k] for k in pair] != [1, 1] or any(n_p[k] for k in pair):
        fail(f"pose_chain: compositor launches for d loss / d se3: kernels {n_k}, plain {n_p}")
    # the backward kernel of one test-time iteration: the rgb MLP at
    # tt_rays x n_compact rows, bf16; dW is a third of its products
    rows = n_rays * trainer.rcfg.n_compact
    widths = SHAPES["rgb"]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((rows, widths[0]), device="cuda", generator=g).to(torch.bfloat16)
    ws = [(torch.randn((a, b), device="cuda", generator=g) / a ** 0.5).to(torch.bfloat16)
          for a, b in zip(widths[:-1], widths[1:])]
    gy = torch.randn((rows, widths[-1]), device="cuda", generator=g).to(torch.bfloat16)
    t_bwd = graph_ms(lambda: fm.fused_mlp_backward(x, ws, gy, need_dx=True))
    with torch.no_grad():
        t_fwd = graph_ms(lambda: fm.fused_mlp(x, ws))
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    tt_ms = float(np.mean([t["ms_per_iter"] for leg in legs.values() for t in leg["tt"]]))
    print(f"pose_chain_grad: gt leg view 0, {n_rays} rays, se3 = 0: loss kernels {l_k:.6f} "
          f"plain {l_p:.6f}; d loss / d se3 kernels {g_k.cpu().numpy().round(6).tolist()} plain "
          f"{g_p.cpu().numpy().round(6).tolist()} |a-b|/|b|={err:.3e} limit={CHAIN_GRAD_TOL:.3e}; "
          f"launches kernels {launch_text(n_k)} plain {launch_text(n_p)}; "
          f"tt backward: fused_mlp_backward rgb {'x'.join(map(str, widths))} bf16 rows={rows} "
          f"need_dx kernel_ms={t_bwd:.4f} (dW {macs} of {3 * macs} MACs per row, discarded) "
          f"forward kernel_ms={t_fwd:.4f}; mean tt iteration {tt_ms:.3f} ms [{card}]",
          flush=True)
    if not err <= CHAIN_GRAD_TOL:
        fail(f"pose_chain: the kernels' pose gradient differs from the plain one by {err}")
    return launches


def phase_tensorf_budget(card: str):
    """Phase 24: cli/tensorf_budget on configs/tensorf/Coffee.txt at 128^2,
    12 views: BUDGET_STEPS steps straight, twice, and split at
    BUDGET_STEPS // 2 (--stop_at, then --resume). The split run's
    parameters and val PSNR must equal the straight run's within
    BUDGET_SPLIT_FACTOR times the two straight runs' spread (bit for bit
    where that spread is 0). Returns the launch counts (TensoRF runs no
    kernel)."""
    import contextlib
    import io
    import os
    import tempfile

    from myc_nerfs_tpu_torch.cli import tensorf_budget as tb
    from myc_nerfs_tpu_torch.core.checkpoint import read_tensorf_checkpoint

    base = ["--steps", str(BUDGET_STEPS), "--val_every", str(BUDGET_STEPS // 2), "--size",
            "128", "--views", "12", "--holdout", "4"]
    runs = {}
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        for name, extra in (("a", []), ("b", []), ("split", ["--stop_at",
                                                             str(BUDGET_STEPS // 2)]),
                            ("split", ["--resume"])):
            with contextlib.redirect_stdout(io.StringIO()):
                res = tb.main(base + ["--ckpt", os.path.join(out, f"{name}.ckpt")] + extra)
            runs[name] = res["log"][-1]
        trees = {n: dict(flat_tree(read_tensorf_checkpoint(os.path.join(out, f"{n}.ckpt"))[0][
            "params"])) for n in ("a", "b", "split")}
        same_ab = all(np.array_equal(trees["a"][k], trees["b"][k]) for k in trees["a"])
        same_split = all(np.array_equal(trees["a"][k], trees["split"][k]) for k in trees["a"])
    seconds = time.perf_counter() - t0
    launches = read_launches()

    def spread(x, y):
        return max(float(np.abs(np.asarray(x[k], np.float64) - y[k]).max()
                         / max(np.abs(y[k]).max(), 1e-30)) for k in y)

    s_ab, s_split = spread(trees["b"], trees["a"]), spread(trees["split"], trees["a"])
    p = {n: runs[n]["val_psnr"] for n in runs}
    print(f"tensorf_budget: cli/tensorf_budget Coffee.txt 128^2 12 views (0, 4, 8 held out), "
          f"{BUDGET_STEPS} steps in chunks of {BUDGET_STEPS // 2}: val_psnr straight "
          f"{p['a']:.4f} / {p['b']:.4f}, split at {BUDGET_STEPS // 2} + --resume "
          f"{p['split']:.4f}; params max |a-b|/max|b| straight-vs-straight {s_ab:.3e} "
          f"(bit_for_bit={same_ab}), split-vs-straight {s_split:.3e} (bit_for_bit={same_split}) "
          f"limit {BUDGET_SPLIT_FACTOR:.0f}x the first; s={seconds:.2f} [{card}]", flush=True)
    if runs["split"]["step"] != BUDGET_STEPS or not all(np.isfinite(list(p.values()))):
        fail(f"tensorf_budget: the split run ended at {runs['split']['step']} or a PSNR is "
             "not finite")
    if same_ab and not same_split:
        fail("tensorf_budget: the straight runs agree bit for bit and the split one does not")
    if not same_ab and not (s_split <= BUDGET_SPLIT_FACTOR * s_ab and
                            abs(p["split"] - p["a"]) <= BUDGET_SPLIT_FACTOR
                            * max(abs(p["b"] - p["a"]), 1e-3)):
        fail(f"tensorf_budget: the split run differs from the straight one by {s_split} "
             f"({p['split']} dB) against a spread of {s_ab} ({p['b']} dB)")
    return launches


def phase_umbrella(card: str):
    """Phase 25: cli/test_scenes --synthetic (TensoRF demo_synthetic 50 steps
    and --render_only, NGP demo_synthetic 50 steps and its test pass) in a
    temporary folder: result/demo_tensorf and result/demo_ngp must hold
    images; then entry()'s render of the flagship (16 levels, brick3, 1024
    rays): rgb finite and not all background, brick_encode and fused_mlp
    launched, and equal to the plain versions' render within ENTRY_TOL.
    Returns the launch counts of both."""
    import contextlib
    import io
    import os
    import tempfile

    from myc_nerfs_tpu_torch.cli import test_scenes
    from myc_nerfs_tpu_torch.entry import entry

    configs = os.path.abspath("configs")
    cwd = os.getcwd()
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        os.chdir(out)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                test_scenes.main(["--synthetic", "--configs_root", configs])
            imgs = {d: sorted(os.listdir(os.path.join("result", d)))
                    for d in ("demo_tensorf", "demo_ngp")}
        finally:
            os.chdir(cwd)
    t_scenes = time.perf_counter() - t0
    scenes = read_launches()
    fn, (model, state, rays_o, rays_d) = entry()
    reset_launches()
    rgb = fn(model, state, rays_o, rays_d)
    ran = read_launches()
    model.use_encode_kernel = False
    model.net.use_fully = False
    plain = fn(model, state, rays_o, rays_d)
    model.use_encode_kernel = True
    model.net.use_fully = True
    err = float((rgb - plain).abs().max())
    print(f"umbrella: cli/test_scenes --synthetic s={t_scenes:.2f}: demo_tensorf "
          f"{len(imgs['demo_tensorf'])} files, demo_ngp {len(imgs['demo_ngp'])} files; "
          f"launches {launch_text(scenes)}; entry(): rgb {tuple(rgb.shape)} mean "
          f"{float(rgb.mean()):.4f} min {float(rgb.min()):.4f}, kernels vs plain max_abs_err "
          f"{err:.3e} limit {ENTRY_TOL:.0e}, launches {launch_text(ran)} [{card}]", flush=True)
    if not (imgs["demo_tensorf"] and imgs["demo_ngp"]):
        fail(f"umbrella: result images missing: {imgs}")
    if not (bool(torch.isfinite(rgb).all()) and float((rgb - 1).abs().max()) > 1e-3):
        fail("umbrella: entry()'s render is not finite or all background")
    if not (ran["brick_encode"] > 0 and ran["fused_mlp"] > 0):
        fail(f"umbrella: entry() did not launch brick_encode and fused_mlp: {ran}")
    if not err <= ENTRY_TOL:
        fail(f"umbrella: entry()'s render differs from the plain versions' by {err}")
    return {k: scenes[k] + ran[k] for k in scenes}

# phase 26: cli/multichip's legs on MULTICHIP_RANKS ranks: ngp and render on
# a 2 x 2 mesh (GroupTP), garf and tensorf on 4 x 1; one rank per card on
# NCCL when as many cards are visible, else the ranks share the card under
# gloo. Each leg is held against one process on the same card over the
# whole batch with the same draws and weights (MULTICHIP_TOL: per-step
# losses as |a-b|/|b|, every parameter tensor after the block as |a-b|/|b|:
# the shards' gradients sum in another order and the encode backward's and
# grid_sample backward's atomics add in no fixed order, which Adam's
# first steps turn into a step of up to the learning rate where a gradient
# is near 0. The first run on an H100 80GB HBM3 at 700 W read losses at
# most 1.8e-7, params ngp 6.61e-5, garf 4.82e-4, tensorf 1.31e-7; the
# ngp and garf params limits are ~4x those, the others 1e-5), and the
# parameters every rank must hold (the MLPs and replicated tables;
# GroupTP's local tables within their data group; the pose rows of GARF's
# images) must be bit-equal across those ranks after every step
MULTICHIP_RANKS, MULTICHIP_MESH, MULTICHIP_STEPS = 4, (2, 2), 16
MULTICHIP_TOL = {"ngp": {"loss": 1e-5, "params": 3e-4},
                 "garf": {"loss": 1e-5, "params": 2e-3},
                 "tensorf": {"loss": 1e-5, "params": 1e-5}}


def tree_leaves(tree, prefix=""):
    """(path, numpy array) of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def tree_rel(a, b) -> dict:
    """|a-b|/|b| of every leaf of two trees of one layout, by path."""
    out = {}
    for (pa, x), (pb, y) in zip(tree_leaves(a), tree_leaves(b)):
        if pa != pb or x.shape != y.shape:
            fail(f"multichip: parameter trees differ in layout at {pa} / {pb}")
        out[pa] = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))
    return out


def replicas_equal(results: list, leg: str, group_of) -> tuple:
    """(replicated params equal on every rank after every step, local params
    equal within each group of ranks ``group_of(result)`` names)."""
    rs = [r[leg]["checksums"] for r in results]
    rep = all(c["replicated"] == rs[0][s]["replicated"] for r in rs for s, c in enumerate(r))
    loc = True
    for r, res in zip(rs, results):
        peer = next(x for x in results if group_of(x[leg]) == group_of(res[leg]))
        loc &= all(c["local"] == peer[leg]["checksums"][s]["local"] for s, c in enumerate(r))
    return rep, loc


def phase_multichip(card: str):
    """Phase 26: cli/multichip's ngp (with render), garf and tensorf legs at
    full width on MULTICHIP_RANKS spawned ranks (mesh.spawn; the kernels
    were built by phase 2, the ranks load them), each against one process on
    this card over the whole batch (parallel/ranks.py's programs on
    mesh.single_mesh). Every rank's occupancy grid after an update must be
    rank 0's bit for bit. The DP render must equal, bit for bit, one process's
    render of the same trained state (the gathered tables and the grid).
    Returns the launch counts of every rank's ngp and render runs."""
    import argparse

    from myc_nerfs_tpu_torch.cli import multichip as mc
    from myc_nerfs_tpu_torch.core import bridge
    from myc_nerfs_tpu_torch.models.ngp import NGPModel
    from myc_nerfs_tpu_torch.parallel import mesh as mesh_lib
    from myc_nerfs_tpu_torch.parallel import ranks
    from myc_nerfs_tpu_torch.render import occupancy as occ
    from myc_nerfs_tpu_torch.render.ngp_render import render_rays_ngp

    data, model = MULTICHIP_MESH
    args = argparse.Namespace(ranks=MULTICHIP_RANKS, data=data, model=model,
                              steps=MULTICHIP_STEPS, small=False)
    legs = mc.build_legs(args)
    legs[0][3]["grid_update"] = True  # one occupancy update after the ngp block
    backend, _, line = mesh_lib.choose_backend("cuda", MULTICHIP_RANKS)
    t0 = time.perf_counter()
    results = mesh_lib.spawn(ranks.run_legs, MULTICHIP_RANKS, "cuda", legs, model=model,
                             timeout=900.0, quiet=True)
    t_ranks = time.perf_counter() - t0
    one = mesh_lib.single_mesh("cuda")
    refs = {}
    for name, kind, _, spec in legs:
        ref_spec = dict(spec, table_mode="replicated") if kind == "ngp" else spec
        refs[name] = ranks.LEG_FNS[kind](one, ref_spec)
    print(f"multichip: {line}; {MULTICHIP_RANKS} ranks ran every leg in {t_ranks:.2f} s "
          f"(spawn and start-up included) [{card}]", flush=True)
    ok = True
    for name, kind, m, spec in legs:
        key = "mse" if kind == "tensorf" else "loss"
        mine, ref = results[0][name], refs[name]
        loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(mine[key], ref[key]))
        rel = tree_rel(mine["params"], ref["params"])
        worst = max(rel, key=rel.get)
        rep, loc = replicas_equal(results, name, lambda r: r["model_index"] if kind == "ngp"
                                  else r["rank"])
        tol = MULTICHIP_TOL[name]
        finite = all(math.isfinite(v) for r in results for v in r[name][key])
        step_ms = 1e3 * float(np.median([np.median(r[name]["step_s"][1:]) for r in results]))
        ref_ms = 1e3 * float(np.median(ref["step_s"][1:]))
        print(f"multichip: {name} mesh {mine['shape']} backend {mine['backend']}: {key} per "
              f"step rank 0 {[f'{v:.6f}' for v in mine[key]]}, one process "
              f"{[f'{v:.6f}' for v in ref[key]]}, max |a-b|/|b| {loss_rel:.3e} "
              f"(tol {tol['loss']:.0e}); params after {len(mine[key])} steps max |a-b|/|b| "
              f"{rel[worst]:.3e} at {worst} (tol {tol['params']:.0e}); replicated params "
              f"bit-equal on every rank after every step {rep}, local ones within their "
              f"group {loc}; finite {finite}; step ms median {step_ms:.3f} ({MULTICHIP_RANKS} "
              f"ranks on {backend}) vs one process {ref_ms:.3f} [{card}]", flush=True)
        ok &= (loss_rel <= tol["loss"] and rel[worst] <= tol["params"] and rep and loc
               and finite)
    # the occupancy update runs with no collective: every rank's grid must
    # come out rank 0's
    r0 = results[0]["ngp"]
    grids = all(r["ngp"]["grid_checksum"] == r0["grid_checksum"] for r in results)
    print(f"multichip: occupancy grid after an update on every rank, no collective: "
          f"equal to rank 0's bit for bit {grids} [{card}]", flush=True)
    ok &= grids
    # the DP render against one process's render of the same trained state
    spec = legs[0][3]
    rcfg, ro, rd = spec["render"]
    state_model = NGPModel(spec["model_cfg"], device="cuda")
    bridge.load_params(state_model, r0["params"])
    grid = bridge.occupancy_from_numpy(r0["occ"], "cuda")
    with torch.no_grad():
        plain = render_rays_ngp(occ.OccupancyConfig(), rcfg, state_model, grid,
                                torch.from_numpy(ro).to("cuda"), torch.from_numpy(rd).to("cuda"),
                                torch.ones(3, device="cuda"))
    same = all(np.array_equal(r["ngp"]["render"]["rgb"], plain.rgb.cpu().numpy())
               and np.array_equal(r["ngp"]["render"]["depth"], plain.depth.cpu().numpy())
               for r in results)
    print(f"multichip: render {ro.shape[0]} rays n_coarse {rcfg.n_coarse} K {rcfg.n_samples} "
          f"eps {rcfg.early_stop_eps} on {MULTICHIP_MESH[0]} x {MULTICHIP_MESH[1]} (GroupTP "
          f"tables): equal to one process's render of the same state bit for bit {same} "
          f"(max |a-b| {float(np.abs(r0['render']['rgb'] - plain.rgb.cpu().numpy()).max()):.3e}), "
          f"samples {r0['render']['n_samples']} vs {int(plain.n_samples)}; render s "
          f"{max(r['ngp']['render']['s'] for r in results):.4f} [{card}]", flush=True)
    launches = {k: 0 for k in KERNELS}
    per_rank = []
    for r in results:
        run = {k: r["ngp"]["launches"][k] + r["ngp"]["render"]["launches"][k]
               for k in ranks.KERNEL_COUNTERS}
        per_rank.append(run)
        for k, v in run.items():
            launches[k] += v
    print("multichip: launches per rank (ngp train + render): "
          + "; ".join(f"rank {i} {launch_text(run)}" for i, run in enumerate(per_rank)),
          flush=True)
    if not all(r["ngp"]["launches"][k] > 0 for r in results for k in ranks.KERNEL_COUNTERS):
        fail(f"multichip: an NGP kernel did not launch on every rank: {per_rank}")
    if not ok:
        fail("multichip: a leg disagrees with one process, its replicas differ, or the "
             "ranks' occupancy grids differ")
    if not same:
        fail("multichip: the DP render differs from one process's render of the same state")
    return launches


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
    # no Pallas kernel: the JAX package's march is XLA
    "march_rays_fused": ("march.cu", "myc_nerfs_tpu/render/ngp_render.py:220", []),
    "march_rays_fused_bwd": ("march.cu", "myc_nerfs_tpu/render/ngp_render.py:220", []),
    # no Pallas kernel: the JAX package's SH encode and concatenation are XLA
    "rgb_input": ("rgb_input.cu", "myc_nerfs_tpu/models/ngp.py:258", []),
    # no Pallas kernel: the JAX package's compositor is XLA
    "ngp_composite": ("composite.cu", "myc_nerfs_tpu/render/composite.py:66",
                      ["myc_nerfs_tpu/render/composite.py:95"]),
    "ngp_composite_bwd": ("composite.cu", "myc_nerfs_tpu/render/composite.py:66",
                          ["myc_nerfs_tpu/render/composite.py:95"]),
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
    stats["march_rays_fused"], stats["march_rays_fused_bwd"] = phase_march()
    stats["rgb_input"] = phase_rgb_input()
    stats["ngp_composite"], stats["ngp_composite_bwd"] = phase_composite()
    stats["fused_mlp_wide"], stats["fused_mlp_wide_bwd"] = phase_kernel_wide(fm)
    probe = phase_probe()
    grid, render = phase_slice(smi)
    train, train_ctx = phase_train(smi)
    nerf, nerf_ctx = phase_nerf_train(smi)
    flagship, flagship_ctx = phase_flagship_fused(smi, nerf_ctx)
    hash_march = phase_hash_march(smi)
    phase_profile(smi, train_ctx, flagship_ctx)
    phase_split(smi, train_ctx)
    garf, _ = phase_garf_train(smi)
    phase_pose_recovery(smi)
    phase_nerf_grad(smi)
    barf, _ = phase_barf_train(smi)
    tensorf = phase_tensorf_train(smi)
    tensorf_step = phase_tensorf_step(smi)
    tensorf_variants = phase_tensorf_variants(smi)
    evaluate = phase_evaluate(smi)
    chain = phase_pose_chain(smi)
    budget = phase_tensorf_budget(smi)
    umbrella = phase_umbrella(smi)
    multichip = phase_multichip(smi)
    # the main-path runs (the BARF family's and TensoRF's launch no kernel)
    runs = (grid, render, train, nerf, flagship, hash_march, garf, barf, tensorf,
            tensorf_step, *tensorf_variants, evaluate, chain, budget, umbrella, multichip)
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
