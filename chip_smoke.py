"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, one line each (a failure exits non-zero):
1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles myc_nerfs_tpu_torch/csrc/fused_mlp.cu with nvcc.
3. kernel: fused_mlp against its plain PyTorch version at both NGP MLP
   shapes (density 32->64->16, rgb 32->64->64->16), 262144 rows (one
   4096-ray x 64-sample render chunk), f32 and bf16, TF32 off; max abs
   error against the stated tolerance and median times from CUDA events.
4. slice: run_net.build_trainer on configs/ngp/Car.py (L16F2, 2^19,
   aabb_scale 4, fp16 -> bf16 MLPs, use_fully) with seeded random
   weights, 16 occupancy-grid updates, then two 800x800 frames rendered
   along the spherical path; the frames must be finite and not all
   background, and the MLPs must have run through the kernel. One chunk
   of rays is rendered again with the plain MLP and compared.
Then a JSON line describing each kernel, and last the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

ROWS = 262144                       # 4096 rays x 64 samples
SHAPES = {"density": (32, 64, 16), "rgb": (32, 64, 64, 16)}
# f32: 32-64-term dot products summed in another order than cuBLAS's, on
# O(1) values. bf16: the output is rounded to bf16 after every layer, so a
# sum that lands on the other side of a rounding boundary shifts an
# intermediate by one bf16 ulp; allow two ulps of the output's scale.
TOL = {torch.float32: lambda scale: 1e-4 * max(1.0, scale),
       torch.bfloat16: lambda scale: 2.0 ** -7 * max(1.0, scale)}
FRAMES, H, W = 2, 800, 800          # configs/ngp/Car.py test split


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def phase_kernel(fm) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, widths in SHAPES.items():
            x = torch.rand((ROWS, widths[0]), device="cuda", generator=g).to(dtype)
            ws = [(torch.randn((widths[i], widths[i + 1]), device="cuda",
                               generator=g) / widths[i] ** 0.5).to(dtype)
                  for i in range(len(widths) - 1)]
            with torch.no_grad():
                y = fm.fused_mlp(x, ws)
                ref = fm.fused_mlp_reference(x, ws)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = TOL[dtype](scale)
                t_k = median_ms(lambda: fm.fused_mlp(x, ws))
                t_p = median_ms(lambda: fm.fused_mlp_reference(x, ws))
            ok = err <= tol
            print(f"kernel: fused_mlp {name} {'x'.join(map(str, widths))} "
                  f"{str(dtype).split('.')[-1]} rows={ROWS} tf32=off "
                  f"max_abs_err={err:.3e} tol={tol:.3e} "
                  f"{'ok' if ok else 'BREACH'} kernel_ms={t_k:.4f} "
                  f"plain_ms={t_p:.4f}", flush=True)
            if not ok:
                fail(f"fused_mlp {name} {dtype}: max abs err {err} > {tol}")
            if dtype == torch.bfloat16:  # the Car slice's dtype
                worst = max(worst, err)
                ms += t_k
                plain_ms += t_p
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_slice(fm, card: str) -> int:
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
            and trainer.rcfg.aabb_scale == 4):
        fail(f"Car config did not build as expected: {model.cfg}")
    intr = torch.tensor([[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1.0]])
    poses = [run_net.path_pose(p) for p in path_spherical(FRAMES)]

    # the main path: grid updates, then the render; both run the kernel
    torch.cuda.synchronize()
    fm.fused_mlp.launches = 0
    t0 = time.perf_counter()
    for _ in range(16):
        trainer.state = trainer.state._replace(
            occ=trainer.grid_update(trainer.state.occ, gen))
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    occ_frac = trainer.state.occ.bitfield.float().mean().item()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = [trainer.render_image(p, intr, H, W)[0] for p in poses]
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    launches = fm.fused_mlp.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rgb = torch.stack(frames)
    bg = torch.tensor(trainer.cfg.background_color, device="cuda")
    non_bg = ((rgb - bg).abs().amax(-1) > 1e-3).float().mean().item()
    rays_s = FRAMES * H * W / t_render
    print(f"slice: Car L16F2 2^19 aabb_scale=4 bf16 use_fully "
          f"grid_updates=16 ({t_grid:.2f} s) occupied={occ_frac:.4f} "
          f"frames={FRAMES}x{H}x{W} render_s={t_render:.3f} "
          f"rays_per_s={rays_s:.0f} peak_mem_gib={peak_gib:.2f} "
          f"non_background={non_bg:.4f} fused_mlp_launches={launches} "
          f"[{card}]", flush=True)
    if tuple(rgb.shape) != (FRAMES, H, W, 3) or not torch.isfinite(rgb).all():
        fail("render output is not finite or has the wrong shape")
    if non_bg < 1e-3:
        fail("render is all background")
    if launches == 0:
        fail("the render did not run the fused_mlp kernel")

    # the same rays through the plain MLP: the slice agrees with its
    # reference path (bf16 both ways; see TOL for the rounding allowance)
    from myc_nerfs_tpu_torch.geom import rays as rays_lib
    from myc_nerfs_tpu_torch.render.ngp_render import render_rays_ngp

    pose = poses[0].to("cuda")
    d = rays_lib.get_ray_directions(H, W, (W * 0.6, W * 0.6), device="cuda")
    rays_d = d.reshape(-1, 3)[::157][:4096] @ pose[:3, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    outs = []
    with torch.no_grad():
        for use_fully in (True, False):
            model.net.use_fully = use_fully
            outs.append(render_rays_ngp(trainer.occ_cfg, trainer.rcfg, model,
                                        trainer.state.occ, rays_o, rays_d, bg).rgb)
    model.net.use_fully = True
    diff = (outs[0] - outs[1]).abs().amax(-1)
    print(f"slice: kernel vs plain MLP on {rays_d.shape[0]} rays: "
          f"max_abs_rgb_diff={diff.max().item():.3e} "
          f"rays_over_1e-2={(diff > 1e-2).float().mean().item():.5f}", flush=True)
    if (diff > 1e-2).float().mean().item() > 1e-3:
        fail("kernel and plain MLP renders disagree")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    path, secs = fm.build()
    print(f"build: {fm.SOURCE.relative_to(fm._PKG.parent)} -> "
          f"{path.relative_to(fm._PKG.parent)} in {secs:.2f} s", flush=True)
    kstats = phase_kernel(fm)
    launches = phase_slice(fm, smi)
    print(json.dumps({"kernels": [{
        "name": "fused_mlp", "route": "cuda",
        "source": "myc_nerfs_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "myc_nerfs_tpu/ops/pallas/fused_mlp.py:34",
        "launches": launches, **kstats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
