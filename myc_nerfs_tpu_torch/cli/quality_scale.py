"""Quality runs at reference scale on the card (counterpart of
scripts/quality_scale.py).

Trains on the detail-rich procedural scene (256^2, 36 views in three
elevation rings; data/synthetic.make_detail_scene) and reports the val PSNR
of three held-out views (0, n/3, 2n/3), with the JAX harness's settings:
world -> box by SCALE/OFF, bf16, 8192 rays per step, a grid update every 16
steps, ExpDecay from step 20000, near 0.05. Variants:

  --variant brick3    L16F2 brick3 tables + fused march (the NGP default)
  --variant hash      the reference-shaped vertex hash + bitfield march +
                      detached-network compaction (the parity anchor)
  --variant flagship  OriginNeRF (D=8, W=256, skips=()) behind the same
                      fused march; --fused runs its backbone through the
                      fused-MLP kernels (ops/cuda/fused_mlp, wide chain)

  --scene cascade --aabb_scale 4 --views 72   four rings, one val view each

``--ckpt f`` saves every 2048 steps and at the end (core/checkpoint.py's
codec); ``--resume`` restores it first. Prints progress lines and, last,
one JSON line: {variant, scene, steps, train_psnr, val_psnr, val_psnrs,
wall_s, krays_s, ...} with the card's name and power limit.

    python -m myc_nerfs_tpu_torch.cli.quality_scale --variant brick3 --steps 6000
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..core.checkpoint import restore_checkpoint, save_checkpoint
from ..data import synthetic as syn
from ..geom import rays as rays_lib
from ..models import ngp
from ..models.ori_nerf import OriginNeRFConfig, OriginNeRFModel
from ..ops.cuda import fused_mlp as fm
from ..render.ngp_render import NGPRenderConfig
from ..train.ngp_trainer import NGPTrainConfig, NGPTrainer
from ..utils.metrics import psnr

# uniform and non-uniform samples of each occupancy update (the JAX harness's)
GRID_SAMPLES = 1 << 16


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="brick3", choices=["brick3", "hash", "flagship"])
    ap.add_argument("--fused", action="store_true",
                    help="flagship: the backbone through the fused-MLP kernels")
    ap.add_argument("--f32", action="store_true", help="flagship: f32 params and compute")
    ap.add_argument("--lr", type=float, default=1e-2,
                    help="1e-2 (the reference's); the flagship trains at 1e-3")
    ap.add_argument("--n_coarse", type=int, default=128)
    ap.add_argument("--n_compact", type=int, default=20)
    ap.add_argument("--nc_schedule", default="",
                    help="staged march budget, e.g. '0:20,20000:32'")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--scene", default="detail", choices=["detail", "cascade"])
    ap.add_argument("--aabb_scale", type=int, default=1)
    ap.add_argument("--views", type=int, default=36)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--val_every", type=int, default=0,
                    help="if > 0, print view 0's val PSNR at this cadence")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, march jitter and grid draws (torch generator) "
                         "and the ray batches (numpy default_rng)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for a smoke run)")
    return ap.parse_args(argv)


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (or the
    device type off the card)."""
    if device.type != "cuda":
        return device.type
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)


def build_scene(args, device):
    if args.scene == "cascade":
        return syn.make_cascade_scene(n_views=args.views, H=args.size, W=args.size,
                                      device=device)
    return syn.make_detail_scene(n_views=args.views, H=args.size, W=args.size, device=device)


def val_ids_of(args):
    if args.scene == "cascade":  # one per ring; offset 1 keeps each ring's first view
        per = args.views // 4
        return [1, per + 1, 2 * per + 1, 3 * per + 1]
    return [0, args.views // 3, 2 * args.views // 3]


def build_trainer(args, device, generator):
    fused_march = args.variant != "hash"
    grid_impl = "hash" if args.variant == "hash" else "brick3"
    mcfg = ngp.NGPModelConfig(grid=ngp.HashGridConfig(aabb_scale=args.aabb_scale),
                              use_bf16=True, grid_impl=grid_impl)
    rcfg = NGPRenderConfig(aabb_scale=args.aabb_scale, n_coarse=args.n_coarse,
                           n_samples=64, n_compact=args.n_compact, near_distance=0.05,
                           fused_march=fused_march,
                           compact_source="grid" if fused_march else "network")
    schedule = (tuple(tuple(int(v) for v in p.split(":")) for p in args.nc_schedule.split(","))
                if args.nc_schedule else None)
    tcfg = NGPTrainConfig(lr=args.lr, n_rays_per_batch=args.batch, target_batch_size=1 << 18,
                          n_grid_uniform=GRID_SAMPLES, n_grid_nonuniform=GRID_SAMPLES,
                          decay_start=20000, update_den_freq=16, tot_train_steps=args.steps,
                          n_compact_schedule=schedule)
    model = None
    if args.variant == "flagship":
        model = OriginNeRFModel(OriginNeRFConfig(skips=(), use_bf16=not args.f32,
                                                 use_fused=args.fused),
                                device=device, generator=generator)
    return NGPTrainer(mcfg, rcfg, tcfg, generator, device=device, model=model)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false; "
                         "pass --device cpu to run on the CPU")
    if args.fused and args.variant != "flagship":
        raise SystemExit("--fused applies to --variant flagship")
    card = card_name(device)
    t0 = time.perf_counter()
    scene = build_scene(args, device)
    H = W = args.size
    val_ids = val_ids_of(args)
    train_ids = [i for i in range(args.views) if i not in val_ids]
    c, r = rays_lib.get_center_and_ray(scene.poses[train_ids], scene.intr[train_ids], H, W)
    d = r / torch.linalg.norm(r, dim=-1, keepdim=True)
    tr_o = (c * syn.SCALE + syn.OFF).reshape(-1, 3).to(device)
    tr_d = d.reshape(-1, 3).to(device)
    tr_rgb = scene.images[train_ids].reshape(-1, 3).to(device)
    print(json.dumps({"event": "scene_ready", "wall_s": time.perf_counter() - t0,
                      "train_rays": int(tr_o.shape[0]), "device": card}), flush=True)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    trainer = build_trainer(args, device, gen)
    start = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        trainer.state, meta = restore_checkpoint(args.ckpt, trainer.state)
        start = int(meta.get("step", trainer.state.step))
        trainer.set_host_step(start)
        print(json.dumps({"event": "resumed", "step": start}), flush=True)

    def val_psnr(n=None):
        out = []
        for vi in val_ids[:n or len(val_ids)]:
            R, t = scene.poses[vi][:, :3], scene.poses[vi][:, 3]
            c2w = torch.cat([R.T, (-R.T @ t[:, None]) * syn.SCALE + syn.OFF], 1)
            img, _ = trainer.render_image(c2w, scene.intr[vi], H, W, chunk=min(8192, H * W))
            out.append(float(psnr(torch.clamp(img, 0, 1).cpu(), scene.images[vi])))
        return out

    rng = np.random.default_rng(args.seed)
    S = trainer.cfg.update_den_freq
    launches = (fm.fused_mlp_wide.launches, fm.fused_mlp_wide_backward.launches)
    it, m = start, None
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while it < args.steps:
        trainer.state = trainer.state._replace(occ=trainer.grid_update(trainer.state.occ, gen))
        ids = torch.from_numpy(rng.integers(0, tr_o.shape[0], (S, args.batch))).to(device)
        m = trainer.train_block(tr_o[ids], tr_d[ids], tr_rgb[ids], generator=gen)
        it += S
        if args.val_every and it % args.val_every < S:
            print(json.dumps({"event": "val", "step": it, "train_psnr": float(m["psnr"][-1]),
                              "val_psnr": val_psnr(1)[0],
                              "wall_s": time.perf_counter() - t0}), flush=True)
        if args.ckpt and it % 2048 < S:
            save_checkpoint(args.ckpt, trainer.state, step=it)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ps = val_psnr()
    if args.ckpt:
        save_checkpoint(args.ckpt, trainer.state, step=it)
    print(json.dumps({
        "variant": args.variant, "fused": args.fused, "scene": args.scene,
        "aabb_scale": args.aabb_scale, "views": args.views, "size": args.size,
        "n_compact": args.n_compact, "n_coarse": args.n_coarse, "lr": args.lr,
        "batch": args.batch, "seed": args.seed, "steps": it,
        "train_psnr": float(m["psnr"][-1]) if m is not None else None,
        "val_psnr": float(np.mean(ps)), "val_psnrs": ps, "wall_s": wall,
        "krays_s": args.batch * (it - start) / max(wall, 1e-9) / 1e3,
        "wide_kernel_launches": [fm.fused_mlp_wide.launches - launches[0],
                                 fm.fused_mlp_wide_backward.launches - launches[1]],
        "device": card}), flush=True)


if __name__ == "__main__":
    main()
