"""GARF at the reference's Easyship budget on the port (counterpart of
scripts/garf_budget.py; barf options/Easyship.yaml:5,17,21,60).

    python -m myc_nerfs_tpu_torch.cli.garf_budget [--steps 200000] [--views 12]
        [--size 128] [--noise 0.06] [--log_every 10000] [--gate_frac 0.4]
        [--rand_rays 2048] [--samples 128] [--ckpt f --resume] [--device cuda]

GARF (6 x 256 gaussian layers, no PE) on the textured synthetic scene with
injected se(3) pose noise, 2048 rays x 128 samples per step, pose
correction from ``gate_frac`` of the steps. Prints JSON lines to stdout:
``garf_budget_start`` (the initial Procrustes-aligned rotation and
translation errors, the device), ``garf_budget_log`` every ``log_every``
steps (train PSNR, rotation error mean / median / max in degrees,
translation error, it/s) and ``garf_budget_done`` (final errors and the
trailing-window statistics of the last quarter). The pose noise comes from
a torch generator, so the initial error differs from the JAX script's:
compare final over initial ratios, not values.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.checkpoint import restore_checkpoint, save_checkpoint
from ..data.synthetic import make_scene
from ..evaluation import pose_eval
from ..geom import lie
from ..geom import pose as pose_lib
from ..train import nerf_trainer as nt

BLOCK = 16  # steps between host reads


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def pose_error_full(poses: torch.Tensor, poses_gt: torch.Tensor):
    """(mean, median, max) rotation error in degrees and the mean translation
    error after Procrustes alignment; the median says whether the bulk of
    the cameras improved, since one outlier moves the mean through the
    alignment."""
    poses, poses_gt = poses.detach().cpu(), poses_gt.cpu()
    aligned, _ = pose_eval.prealign_cameras(poses, poses_gt)
    err = pose_eval.evaluate_camera_alignment(aligned, poses_gt)
    r = torch.rad2deg(err.R)
    return float(r.mean()), float(torch.median(r)), float(r.max()), float(err.t.mean())


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200000)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.06)
    ap.add_argument("--log_every", type=int, default=10000)
    ap.add_argument("--ckpt", default="", help="checkpoint path, saved at every log")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--rand_rays", type=int, default=2048, help="reference: Easyship.yaml:21")
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--gate_frac", type=float, default=0.4,
                    help="start_pose_correct_iter as a fraction of steps (0.4 = "
                         "Easyship.yaml:60's 80k/200k; 0 = no gate)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; pass --device cpu to run on the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is false; "
                         "pass --device cpu to run on the CPU")

    scene = make_scene(n_views=args.views, H=args.size, W=args.size, textured=True)
    images, poses, intr = (x.to(device) for x in (scene.images, scene.poses, scene.intr))
    cfg = nt.NeRFTrainConfig(model="garf", refine_pose=True, camera_noise=args.noise,
                             rand_rays=args.rand_rays, sample_intvs=args.samples,
                             max_iter=args.steps,
                             start_pose_correct_iter=int(args.steps * args.gate_frac))
    state = nt.init_state(cfg, torch.Generator(device=device).manual_seed(0),
                          args.views, device)
    noisy = pose_lib.compose_pair(lie.se3_to_SE3(state.pose_noise), poses)
    r0, _, _, t0_err = pose_error_full(noisy, poses)
    emit(event="garf_budget_start", steps=args.steps, views=args.views, size=args.size,
         noise=args.noise, start_pose_correct=cfg.start_pose_correct_iter,
         rot_err_deg_init=round(r0, 3), trans_err_init=round(t0_err, 4),
         device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"))

    step = nt.make_train_step(cfg, images, poses, intr)
    gen = torch.Generator(device=device).manual_seed(2)

    def block(state):
        draws = [nt.draw_step(cfg, args.views, args.size, args.size, gen, device)
                 for _ in range(BLOCK)]
        return nt.train_block(step, state, draws)

    it = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        state, meta = restore_checkpoint(args.ckpt, state)
        it = int(meta.get("step", 0))
        emit(event="garf_budget_resumed", step=it)
    state, m = block(state)  # the first block is warm-up, outside the timed window
    float(m["psnr"])
    it += BLOCK
    it0, wall0 = it, time.perf_counter()
    next_log = (it // args.log_every + 1) * args.log_every
    traj = []  # (step, rot mean, rot median, trans) for the trailing window
    while it < args.steps:
        state, m = block(state)
        it += BLOCK
        if it >= next_log or it >= args.steps:
            p = float(m["psnr"])
            wall = time.perf_counter() - wall0
            r1, rmed, rmax, t1 = pose_error_full(
                nt.compose_refined_pose(cfg, state, poses), poses)
            traj.append((it, r1, rmed, t1))
            emit(event="garf_budget_log", step=it, train_psnr=round(p, 2),
                 rot_err_deg=round(r1, 3), rot_err_med=round(rmed, 3),
                 rot_err_max=round(rmax, 3), trans_err=round(t1, 4),
                 it_s=round((it - it0) / wall, 1), wall_s=round(wall, 1))
            next_log += args.log_every
            if args.ckpt:
                save_checkpoint(args.ckpt, state, step=it)
    r1, _, _, t1 = pose_error_full(nt.compose_refined_pose(cfg, state, poses), poses)
    # the endpoint of a noisy trajectory is not evidence: aggregate the
    # final quarter of the logged trajectory as well
    tail = [row for row in traj if row[0] > 0.75 * args.steps]
    trailing = {}
    if tail:
        rm = np.array([row[1] for row in tail])
        rmed_t = np.array([row[2] for row in tail])
        tm = np.array([row[3] for row in tail])
        trailing = dict(trailing_window_steps=[tail[0][0], tail[-1][0]],
                        trailing_rot_mean=round(float(rm.mean()), 3),
                        trailing_rot_mean_range=[round(float(rm.min()), 3),
                                                 round(float(rm.max()), 3)],
                        trailing_rot_med_mean=round(float(rmed_t.mean()), 3),
                        trailing_trans_mean=round(float(tm.mean()), 4),
                        trailing_improved=bool(rm.mean() < r0))
    emit(event="garf_budget_done", steps=args.steps, views=args.views,
         gate_frac=args.gate_frac, rot_err_deg_init=round(r0, 3),
         rot_err_deg_final=round(r1, 3), trans_err_init=round(t0_err, 4),
         trans_err_final=round(t1, 4), improved=bool(r1 < r0),
         rot_ratio=round(r1 / r0, 4) if r0 else math.nan,
         trans_ratio=round(t1 / t0_err, 4) if t0_err else math.nan,
         wall_s=round(time.perf_counter() - wall0, 1), **trailing)


if __name__ == "__main__":
    main()
