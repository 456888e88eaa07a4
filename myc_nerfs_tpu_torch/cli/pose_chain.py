"""The pose chain at reference scale (counterpart of
scripts/pose_chain_scale.py): noisy cameras -> GARF joint pose refinement ->
a sim3 transfer of the val poses -> Instant-NGP on the gt, noisy and
refined cameras -> per-view test-time photometric pose optimisation.

    python -m myc_nerfs_tpu_torch.cli.pose_chain [--garf_steps 50000]
        [--ngp_steps 6000] [--noise 0.06] [--views 36] [--size 256]
        [--batch 8192] [--gate_frac 0] [--skip gt,noisy,refined] [--no_tt]
        [--tt_rays 2048] [--tt_iters 1500] [--tt_lr 3e-3] [--small]
        [--out_dir pose_chain_out] [--device cuda]

The scene is the 256^2 detail scene (data/synthetic.make_detail_scene),
views 0, n/3 and 2n/3 held out. GARF (6 x 256 gaussian layers, 2048 rays x
128 samples) refines the noisy training cameras, with the correction from
``gate_frac`` of its steps (0: from step 0, the reference's synthetic-noise
protocol; 0.4: Easyship.yaml's 80k / 200k). Each NGP leg trains the L16F2
brick3 field (bf16, fused march, n_coarse 128, n_samples 64, n_compact 20,
8192 rays per step toward 2^18 samples) and reports the val PSNR of the
held-out views, and with test-time optimisation (on unless ``--no_tt``) the
PSNR after a per-view se(3) correction fitted against the trained field:

  gt       the ground-truth training cameras (the ceiling);
  noisy    the noisy cameras, Procrustes-aligned to the GT frame;
  refined  GARF's cameras in their own frame; the GT val poses are carried
           into that frame by compare_pose's sim3 (compare_pose.py:9-85).

Prints JSON lines to stdout (pose_chain_start, pose_chain_garf_log,
pose_chain_garf_done, pose_chain_export, pose_chain_compare_pose, one
pose_chain_ngp per leg, pose_chain_done), each NGP line with its kernel
launches. The transforms JSONs go to ``--out_dir``. The pose noise comes
from a torch generator, so compare error ratios with the JAX script's, not
raw errors.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import synthetic as syn
from ..evaluation import pose_eval
from ..evaluation.pose_export import compare_pose, load_transforms_json, write_transforms_json
from ..evaluation.test_time_optim import make_ngp_pose_loss, pixel_draws, test_time_pose_optim
from ..geom import lie
from ..geom import pose as pose_lib
from ..geom import rays as rays_lib
from ..geom.conventions import parse_raw_camera_barf
from ..models import ngp
from ..ops.cuda import fused_mlp as fm
from ..ops.cuda import grid_encode as ge
from ..render.ngp_render import NGPRenderConfig
from ..train import nerf_trainer as nt
from ..train.ngp_trainer import NGPTrainConfig, NGPTrainer
from ..utils.metrics import psnr

SCALE, OFF = syn.SCALE, syn.OFF
GARF_BLOCK = 16    # GARF steps between host reads
TT_STOP_LOSS = 7e-4
LEGS = ("gt", "noisy", "refined")


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def launches() -> Dict[str, int]:
    """The four NGP kernels' launch counts."""
    return {"fused_mlp": fm.fused_mlp.launches, "fused_mlp_bwd": fm.fused_mlp_backward.launches,
            "brick_encode": ge.brick_encode.launches,
            "brick_encode_bwd": ge.brick_encode_backward.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launches().items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--garf_steps", type=int, default=50000)
    ap.add_argument("--ngp_steps", type=int, default=6000)
    ap.add_argument("--noise", type=float, default=0.06)
    ap.add_argument("--views", type=int, default=36)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--rand_rays", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--log_every", type=int, default=10000)
    ap.add_argument("--skip", default="", help="comma list of NGP legs to skip: gt,noisy,refined")
    ap.add_argument("--gate_frac", type=float, default=0.0,
                    help="start_pose_correct_iter as a fraction of garf_steps (0: from step "
                         "0, the reference's synthetic-noise protocol; 0.4: Easyship.yaml)")
    ap.add_argument("--no_tt", action="store_true",
                    help="no per-view test-time photometric pose optimisation")
    ap.add_argument("--tt_rays", type=int, default=2048)
    ap.add_argument("--tt_iters", type=int, default=1500)
    ap.add_argument("--tt_lr", type=float, default=3e-3)
    ap.add_argument("--small", action="store_true",
                    help="a small NGP grid (8 levels, 2^15 rows, 256 finest) for smoke runs")
    ap.add_argument("--out_dir", default="pose_chain_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu for a smoke run)")
    return ap.parse_args(argv)


def pose_error(poses: torch.Tensor, poses_gt: torch.Tensor):
    """Mean rotation error (degrees) and mean translation error after
    Procrustes alignment, on the CPU."""
    poses, poses_gt = poses.detach().cpu(), poses_gt.cpu()
    aligned, _ = pose_eval.prealign_cameras(poses, poses_gt)
    err = pose_eval.evaluate_camera_alignment(aligned, poses_gt)
    return float(torch.rad2deg(err.R).mean()), float(err.t.mean())


def field_c2w(pose_w2c: torch.Tensor) -> torch.Tensor:
    """w2c [3, 4] -> c2w [3, 4] in the field's unit-AABB frame."""
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    return torch.cat([R.T, (-R.T @ t[:, None]) * SCALE + OFF], 1)


def build_ngp_trainer(steps: int, batch: int, small: bool, device, generator) -> NGPTrainer:
    """The script's NGP leg (pose_chain_scale.py:114-127)."""
    gcfg = (ngp.HashGridConfig(aabb_scale=1, n_levels=8, log2_hashmap_size=15,
                               desired_resolution=256.0) if small
            else ngp.HashGridConfig(aabb_scale=1))
    mcfg = ngp.NGPModelConfig(grid=gcfg, use_bf16=True, grid_impl="brick3")
    rcfg = NGPRenderConfig(aabb_scale=1, n_coarse=128, n_samples=64, n_compact=20,
                           near_distance=0.05, fused_march=True, compact_source="grid")
    tcfg = NGPTrainConfig(lr=1e-2, n_rays_per_batch=batch, target_batch_size=1 << 18,
                          n_grid_uniform=1 << 16, n_grid_nonuniform=1 << 16,
                          decay_start=20000, update_den_freq=16, tot_train_steps=steps)
    return NGPTrainer(mcfg, rcfg, tcfg, generator, device=device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def test_time_correct(trainer: NGPTrainer, pose_w2c, intr, image, H: int, W: int, vi: int,
                      tt: dict, device):
    """The per-view test-time optimisation from ``pose_w2c``: (corrected
    pose, {iters, loss, reason, ms_per_iter})."""
    loss_fn = make_ngp_pose_loss(trainer.occ_cfg, trainer.rcfg, trainer.model, trainer.state.occ,
                                 pose_w2c, intr, image, H, W, world_scale=SCALE,
                                 world_offset=OFF, bg=torch.ones(3, device=device),
                                 density_apply=trainer.model.density_raw)
    draw = pixel_draws(tt["rays"], H * W, torch.Generator(device=device).manual_seed(5000 + vi),
                       device)
    sync(device)
    t0 = time.perf_counter()
    res = test_time_pose_optim(loss_fn, draw, lr=tt["lr"], max_iter=tt["iters"],
                               stop_loss=TT_STOP_LOSS, device=device)
    n = int(res.n_iters)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / max(n, 1)
    corr = pose_lib.compose_pair(lie.se3_to_SE3(res.se3)[0], pose_w2c)
    return corr, {"iters": n, "loss": round(float(res.loss), 6), "reason": res.reason,
                  "ms_per_iter": round(ms, 4)}


def train_ngp(tag: str, poses_w2c, images, intr, scene, val_ids, args, device,
              val_poses=None, tt: Optional[dict] = None) -> dict:
    """One NGP leg on the rays of the given train cameras; the val PSNR of
    each held-out view from ``val_poses`` (default: the GT poses), and with
    ``tt`` after its test-time correction. Returns the JSON payload with the
    trainer under "trainer"."""
    H = W = scene.H
    c, r = rays_lib.get_center_and_ray(poses_w2c.cpu(), intr.cpu(), H, W)
    d = r / torch.linalg.norm(r, dim=-1, keepdim=True)
    tr_o = (c * SCALE + OFF).reshape(-1, 3).to(device)
    tr_d = d.reshape(-1, 3).to(device)
    tr_rgb = images.reshape(-1, 3).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    trainer = build_ngp_trainer(args.ngp_steps, args.batch, args.small, device, gen)
    rng = np.random.default_rng(0)
    S = trainer.cfg.update_den_freq
    before = launches()
    sync(device)
    t0 = time.perf_counter()
    it, m, first = 0, None, None
    while it < args.ngp_steps:
        trainer.state = trainer.state._replace(occ=trainer.grid_update(trainer.state.occ, gen))
        ids = torch.from_numpy(rng.integers(0, tr_o.shape[0], (S, args.batch))).to(device)
        m = trainer.train_block(tr_o[ids], tr_d[ids], tr_rgb[ids], generator=gen)
        first = m["psnr"][0] if first is None else first
        it += S
    sync(device)
    wall = time.perf_counter() - t0
    train_launches = launches_since(before)
    if val_poses is None:
        val_poses = [scene.poses[vi] for vi in val_ids]
    ps, ps_tt, tt_meta = [], [], []
    before = launches()
    for j, vi in enumerate(val_ids):
        pose_w2c = val_poses[j].to(device)
        img, _ = trainer.render_image(field_c2w(pose_w2c), scene.intr[vi], H, W, chunk=8192)
        ps.append(float(psnr(torch.clamp(img, 0, 1).cpu(), scene.images[vi])))
        if tt:
            corr, meta = test_time_correct(trainer, pose_w2c, scene.intr[vi].to(device),
                                           scene.images[vi].to(device), H, W, vi, tt, device)
            img2, _ = trainer.render_image(field_c2w(corr), scene.intr[vi], H, W, chunk=8192)
            ps_tt.append(float(psnr(torch.clamp(img2, 0, 1).cpu(), scene.images[vi])))
            tt_meta.append(meta)
    payload = dict(event="pose_chain_ngp", cameras=tag, steps=it,
                   train_psnr_first=float(first) if first is not None else None,
                   train_psnr=float(m["psnr"][-1]) if m is not None else None,
                   val_psnr=float(np.mean(ps)), val_psnrs=ps, wall_s=wall,
                   krays_s=args.batch * it / max(wall, 1e-9) / 1e3,
                   train_launches=train_launches, eval_launches=launches_since(before))
    if ps_tt:
        payload.update(val_psnr_tt=float(np.mean(ps_tt)), val_psnrs_tt=ps_tt, tt=tt_meta)
    emit(**payload)
    return {**payload, "trainer": trainer}


def garf_leg(args, images_tr, poses_tr, intr_tr, device) -> dict:
    """GARF joint pose refinement on the noisy training cameras."""
    H = W = args.size
    n_train = images_tr.shape[0]
    cfg = nt.NeRFTrainConfig(model="garf", refine_pose=True, camera_noise=args.noise,
                             rand_rays=args.rand_rays, sample_intvs=args.samples,
                             max_iter=args.garf_steps,
                             start_pose_correct_iter=int(args.garf_steps * args.gate_frac))
    state = nt.init_state(cfg, torch.Generator(device=device).manual_seed(0), n_train, device)
    noisy = pose_lib.compose_pair(lie.se3_to_SE3(state.pose_noise), poses_tr)
    r0, t0_err = pose_error(noisy, poses_tr)
    emit(event="pose_chain_start", garf_steps=args.garf_steps, ngp_steps=args.ngp_steps,
         views=args.views, size=args.size, noise=args.noise,
         start_pose_correct=cfg.start_pose_correct_iter, rot_err_deg_init=r0,
         trans_err_init=t0_err, device=str(device))
    step = nt.make_train_step(cfg, images_tr, poses_tr, intr_tr)
    gen = torch.Generator(device=device).manual_seed(2)
    it, m = 0, None
    sync(device)
    wall0 = time.perf_counter()
    while it < args.garf_steps:
        draws = [nt.draw_step(cfg, n_train, H, W, gen, device) for _ in range(GARF_BLOCK)]
        state, m = nt.train_block(step, state, draws)
        it += GARF_BLOCK
        if it % args.log_every < GARF_BLOCK:
            r1, t1 = pose_error(nt.compose_refined_pose(cfg, state, poses_tr), poses_tr)
            emit(event="pose_chain_garf_log", step=it, train_psnr=float(m["psnr"]),
                 rot_err_deg=r1, trans_err=t1, it_s=it / (time.perf_counter() - wall0))
    refined = nt.compose_refined_pose(cfg, state, poses_tr).detach()
    r1, t1 = pose_error(refined, poses_tr)
    sync(device)
    done = dict(event="pose_chain_garf_done", steps=it, gate_frac=args.gate_frac,
                rot_err_deg=r1, trans_err=t1, rot_err_deg_init=r0, trans_err_init=t0_err,
                rot_ratio=r1 / r0 if r0 else math.nan,
                trans_ratio=t1 / t0_err if t0_err else math.nan,
                train_psnr=float(m["psnr"]) if m is not None else None,
                wall_s=time.perf_counter() - wall0)
    emit(**done)
    return {**done, "noisy": noisy.detach(), "refined": refined}


def transfer_val_poses(out_dir: str, poses_tr, refined, val_gt) -> list:
    """The GT val poses carried into the refined cameras' frame by the sim3
    of compare_pose (old val = GT train, new val = refined train, old test
    = GT val), each parsed back to a world->cam pose."""
    p = {k: os.path.join(out_dir, f"chain_{k}.json")
         for k in ("val_old", "val_new", "test_old", "test_new")}
    write_transforms_json(p["val_old"], poses_tr)
    write_transforms_json(p["val_new"], refined)
    write_transforms_json(p["test_old"], val_gt)
    compare_pose(p["val_old"], p["val_new"], p["test_old"], p["test_new"], method="sim3")
    c2w_new, _, _ = load_transforms_json(p["test_new"])
    emit(event="pose_chain_compare_pose", method="sim3", path=p["test_new"],
         n_test=int(val_gt.shape[0]))
    return [parse_raw_camera_barf(c2w_new[j]) for j in range(val_gt.shape[0])]


def run(args) -> dict:
    """The whole chain; returns {"garf", "legs" (tag -> payload with its
    trainer), "scene", "val_ids", "val_poses" (tag -> poses)}."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is false; "
                         "pass --device cpu to run on the CPU")
    os.makedirs(args.out_dir, exist_ok=True)
    skip = set(filter(None, args.skip.split(",")))
    scene = syn.make_detail_scene(n_views=args.views, H=args.size, W=args.size, device=device)
    val_ids = [0, args.views // 3, 2 * args.views // 3]
    train_ids = [i for i in range(args.views) if i not in val_ids]
    poses_tr, images_tr, intr_tr = (scene.poses[train_ids], scene.images[train_ids],
                                    scene.intr[train_ids])
    garf = garf_leg(args, images_tr.to(device), poses_tr.to(device), intr_tr.to(device), device)
    noisy, refined = garf["noisy"].cpu(), garf["refined"].cpu()
    refined_aligned, _ = pose_eval.prealign_cameras(refined, poses_tr)
    noisy_aligned, _ = pose_eval.prealign_cameras(noisy, poses_tr)
    export = os.path.join(args.out_dir, "transforms_train.json")
    write_transforms_json(export, refined_aligned)
    emit(event="pose_chain_export", path=export, n_frames=len(train_ids))
    val_refined = transfer_val_poses(args.out_dir, poses_tr, refined,
                                     torch.stack([scene.poses[v] for v in val_ids]))
    tt = None if args.no_tt else {"rays": args.tt_rays, "iters": args.tt_iters, "lr": args.tt_lr}
    cameras = {"gt": (poses_tr, None), "noisy": (noisy_aligned, None),
               "refined": (refined, val_refined)}
    legs = {}
    for tag in LEGS:
        if tag in skip:
            continue
        poses, val_poses = cameras[tag]
        legs[tag] = train_ngp(tag, poses, images_tr, intr_tr, scene, val_ids, args, device,
                              val_poses=val_poses, tt=tt)
    done = None
    if {"noisy", "refined"} <= legs.keys():
        key = "val_psnr_tt" if tt else "val_psnr"
        done = dict(event="pose_chain_done",
                    val_gain_db=legs["refined"][key] - legs["noisy"][key],
                    val_gap_to_gt_db=(legs["gt"][key] - legs["refined"][key]
                                      if "gt" in legs else None),
                    rot_err_reduction=garf["rot_err_deg_init"] / max(garf["rot_err_deg"], 1e-9))
        emit(**done)
    return {"garf": garf, "legs": legs, "scene": scene, "val_ids": val_ids,
            "val_poses": {tag: cameras[tag][1] for tag in legs}, "done": done}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
