"""TensoRF's quality gate at Coffee's budget on the port (counterpart of
scripts/tensorf_budget.py).

    python -m myc_nerfs_tpu_torch.cli.tensorf_budget [--steps 30000]
        [--val_every 2000] [--config configs/tensorf/Coffee.txt]
        [--ckpt tensorf_budget_out/tensorf_budget.ckpt] [--resume]
        [--stop_at N] [--device cuda]

Coffee.txt's schedule (upsamples at 2000, 3000, 4000, 5500, 7000 from
2^21 to 300^3 voxels, alpha masks at 2000 and 4000, 4096 rays per step) on
the 256^2 detail scene (data/synthetic.make_detail_scene), 36 views, every
``--holdout``-th view (0, 12, 24) held out, in the aabb [-1.2, 1.2]^3.
Every ``--val_every`` steps: the val PSNR of the held-out views and a
checkpoint (cli/tensorf_train.save_tensorf_ckpt). ``--resume`` continues
from the checkpoint; ``--stop_at N`` ends the run after step N of the
``--steps`` schedule, so a long run can be split across processes with the
same result. After the second alpha-mask event the train rays are
refiltered to the shrunk box, across chunk boundaries too (train.py:
305-312). Chunk c's draws come from a generator seeded from its first step.

The port indexes samples exactly, so the JAX script's TPU budget flags
(--density_budget, --density_batch_budget, --factor_bf16, --app_budget)
are not here. Prints JSON lines to stdout: tensorf_budget_start, one
tensorf_budget_log per chunk (train and val PSNR, grid, rays, it/s and
the seconds of training, validation and checkpoint), tensorf_budget_done.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.synthetic import make_detail_scene
from ..models import tensorf as tfm
from ..train import tensorf_trainer as tt
from ..utils.metrics import psnr as psnr_fn
from .tensorf_train import (build_configs, build_family_trainer, parse_txt_config,
                            restore_tensorf_ckpt, save_tensorf_ckpt)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
AABB = np.asarray([[-1.2] * 3, [1.2] * 3], np.float32)
CHUNK_SEED = 1_000_003  # chunk c's generator: CHUNK_SEED + its first step


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(ROOT, "configs/tensorf/Coffee.txt"))
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--val_every", type=int, default=2000)
    ap.add_argument("--views", type=int, default=36)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--holdout", type=int, default=12,
                    help="every Nth view held out for val (3 of 36)")
    ap.add_argument("--ckpt", default=os.path.join("tensorf_budget_out", "tensorf_budget.ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop_at", type=int, default=0,
                    help="end after this step of the --steps schedule (0: run to --steps)")
    ap.add_argument("--batch", type=int, default=None, help="override batch_size (smoke runs)")
    ap.add_argument("--near", type=float, default=None)
    ap.add_argument("--far", type=float, default=None)
    ap.add_argument("--radii", type=float, default=None, help="NeRF++ background radius")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for a smoke run)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is false; "
                         "pass --device cpu to run on the CPU")
    a = parse_txt_config(args.config)
    a["n_iters"] = args.steps
    if args.batch:
        a["batch_size"] = args.batch
    geom_overrides = {k: getattr(args, k) for k in ("near", "far", "radii")
                      if getattr(args, k) is not None}
    a.update(geom_overrides)
    if geom_overrides:
        a.pop("near_far", None)
    model_cfg, train_cfg = build_configs(a)
    model_name = a.get("model_name", "TensorVMSplit")

    t_scene = time.perf_counter()
    scene = make_detail_scene(n_views=args.views, H=args.size, W=args.size, device=device)
    val_idx = list(range(0, args.views, args.holdout))
    train_idx = [i for i in range(args.views) if i not in val_idx]
    rays = tt.build_ray_store(scene.poses[train_idx], scene.intr[train_idx],
                              args.size, args.size).to(device)
    rgbs = scene.images[train_idx].reshape(-1, 3).to(device)
    val_rays = [tt.build_ray_store(scene.poses[i:i + 1], scene.intr[i:i + 1], args.size,
                                   args.size).to(device) for i in val_idx]
    val_gt = [scene.images[i] for i in val_idx]
    emit(event="tensorf_budget_start", config=os.path.basename(args.config), model=model_name,
         steps=args.steps, views=args.views, size=args.size, val_views=val_idx,
         train_rays=int(rays.shape[0]), upsamp=list(train_cfg.upsamp_list),
         alphamask=list(train_cfg.update_alphamask_list), geom_overrides=geom_overrides or None,
         scene_s=time.perf_counter() - t_scene, device=str(device))

    trainer = build_family_trainer(a, model_cfg, train_cfg, AABB,
                                   torch.Generator(device=device).manual_seed(0), device)
    if args.resume and os.path.exists(args.ckpt):
        restore_tensorf_ckpt(args.ckpt, trainer, for_training=True)
        emit(event="tensorf_budget_resumed", step=trainer.global_step)
    last_mask = max(train_cfg.update_alphamask_list, default=0)

    def refilter(rays, rgbs):
        keep = tfm.filter_rays_bbox(trainer.buffers["aabb"], rays)
        return rays[keep], rgbs[keep]

    if train_cfg.update_alphamask_list and trainer.global_step > last_mask:
        rays, rgbs = refilter(rays, rgbs)
    end = min(args.stop_at, args.steps) if args.stop_at else args.steps
    if os.path.dirname(args.ckpt):
        os.makedirs(os.path.dirname(args.ckpt), exist_ok=True)
    log = []
    wall0 = time.perf_counter()
    it0 = trainer.global_step
    while trainer.global_step < end:
        pre = trainer.global_step
        n = min(args.val_every, end - pre)
        t0 = time.perf_counter()
        m = trainer.train(rays, rgbs, n_iters=n,
                          generator=torch.Generator(device=device).manual_seed(CHUNK_SEED + pre))
        train_psnr = float(m["psnr"])
        t_train = time.perf_counter() - t0
        if train_cfg.update_alphamask_list and pre < last_mask <= trainer.global_step:
            rays, rgbs = refilter(rays, rgbs)
        t0 = time.perf_counter()
        vals = []
        for vr, gt in zip(val_rays, val_gt):
            rgb, _ = trainer.render_rays(vr, chunk=8192)
            vals.append(float(psnr_fn(rgb.reshape(args.size, args.size, 3).cpu(), gt)))
        t_val = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_tensorf_ckpt(args.ckpt, trainer, model_name)
        t_ckpt = time.perf_counter() - t0
        dt = time.perf_counter() - wall0
        line = dict(event="tensorf_budget_log", step=trainer.global_step, train_psnr=train_psnr,
                    val_psnr=float(np.mean(vals)), val_psnrs=vals,
                    grid_size=list(trainer.geom.grid_size), n_train_rays=int(rays.shape[0]),
                    it_s=(trainer.global_step - it0) / dt, wall_s=dt, t_train_s=t_train,
                    t_val_s=t_val, t_ckpt_s=t_ckpt)
        emit(**line)
        log.append(line)
    done = dict(event="tensorf_budget_done", steps=trainer.global_step,
                wall_s=time.perf_counter() - wall0)
    emit(**done)
    return {"log": log, "done": done, "trainer": trainer}


if __name__ == "__main__":
    main()
