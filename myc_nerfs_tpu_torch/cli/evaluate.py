"""BARF-family evaluation CLI (counterpart of myc_nerfs_tpu/cli/evaluate.py;
barf evaluate.py, garf.py:209-269 evaluate_full).

    python -m myc_nerfs_tpu_torch.cli.evaluate --model=garf --yaml=<cfg> \\
        [--optim.test_photo] [--optim.test_iter=N] [--start=0] [--video] [--device=cpu]

Restores ``<output_root>/<group>/<name>/model.ckpt`` (the layout cli/train.py
writes) and, for barf and garf, writes the refined training poses' errors
(``quant_pose.txt``: view, rotation error in radians, translation error)
and ``transform_train.json``. Every view from ``start`` on is rendered,
after a test-time photometric pose optimisation with
``optim.test_photo`` (Adam at lr_pose / 2, stop loss 7e-4, at most
test_iter * 100 iterations, rand_rays pixels at the bin midpoints; its best
loss and iterations go to ``loss.txt``), its PSNR to ``quant.txt`` and the
image to ``rgb_<i>.npy`` (and ``.png`` where PIL is importable). The
optimised poses go to ``transform_val.json`` (``./val/r_{}``); with
``video`` the novel-view videos along an orbit around view 0 (frames where
no encoder is installed).

It runs on the card unless the config key ``device`` says otherwise
(``--device=cpu``), and exits with an error where CUDA is not available.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.checkpoint import restore_checkpoint
from ..evaluation import pose_eval, pose_export
from ..evaluation.test_time_optim import frozen, pixel_draws, test_time_pose_optim
from ..evaluation.visualization import save_image
from ..geom import lie
from ..geom import pose as pose_lib
from ..geom import rays as rays_lib
from ..render.mlp_renderer import render_rays_mlp
from ..train import nerf_trainer as nt
from ..utils.logging import MetricWriter, log
from ..utils.metrics import psnr
from .train import config_to_train_config, load_run_config, load_views

TT_STOP_LOSS = 7e-4


def photometric_loss(tcfg: nt.NeRFTrainConfig, net, pose: torch.Tensor, intr: torch.Tensor,
                     image: torch.Tensor, H: int, W: int):
    """loss_fn(se3, idx): the mean squared error of the pixels ``idx``
    rendered at the bin midpoints from se3_to_SE3(se3) o pose
    (garf.py:232-269); the field's weights are frozen while it is recorded."""
    grid = rays_lib.pixel_grid(H, W, dtype=pose.dtype, device=pose.device)
    target = image.reshape(-1, 3)
    params = list(net.parameters())

    def loss_fn(se3: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        p = pose_lib.compose_pair(lie.se3_to_SE3(se3)[0], pose)
        center, ray = rays_lib.get_center_and_ray(p[None], intr[None], H, W, xy_grid=grid[idx])
        with frozen(params):
            out = render_rays_mlp(lambda pts, du: net(pts, du), center, ray, None,
                                  tcfg.sample_intvs, tcfg.depth_range, view_dep=tcfg.view_dep)
        return ((out.rgb[0] - target[idx]) ** 2).mean()

    return loss_fn


def main(argv: Optional[List[str]] = None,
         tt_draws: Optional[Callable[[int], Callable]] = None) -> str:
    """``tt_draws(i)`` gives view i's pixel draws, draw(it) -> idx (default:
    a generator on the device seeded from the config's seed and i)."""
    cfg = load_run_config(list(sys.argv[1:] if argv is None else argv))
    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device}: torch.cuda.is_available() is false; "
                         "pass --device=cpu to run on the CPU")
    out_dir = os.path.join(cfg.get("output_root", "output"), cfg.get("group", "default"),
                           cfg.get("name", "run"))
    writer = MetricWriter(out_dir)
    images, poses_gt, intr, H, W = (x.to(device) if torch.is_tensor(x) else x
                                    for x in load_views(cfg))
    tcfg = config_to_train_config(cfg)
    seed = cfg.get("seed", 0)
    state = nt.init_state(tcfg, torch.Generator(device=device).manual_seed(seed),
                          images.shape[0], device)
    ckpt = os.path.join(out_dir, "model.ckpt")
    state, meta = restore_checkpoint(ckpt, state)
    log.info(f"restored {ckpt} @ step {meta.get('step')}")

    if tcfg.refine_pose:
        refined = nt.compose_refined_pose(tcfg, state, poses_gt).cpu()
        aligned, _ = pose_eval.prealign_cameras(refined, poses_gt.cpu())
        err = pose_eval.evaluate_camera_alignment(aligned, poses_gt.cpu())
        log.info(f"rot: {np.rad2deg(float(err.R.mean())):8.3f} deg  "
                 f"trans: {float(err.t.mean()):10.5f}")
        for i, (r, t) in enumerate(zip(err.R.tolist(), err.t.tolist())):
            writer.quant_line("quant_pose.txt", i, r, t)
        pose_export.write_transforms_json(os.path.join(out_dir, "transform_train.json"), refined)

    optim = cfg.get("optim", {})
    test_photo = optim.get("test_photo", False) and tcfg.refine_pose
    max_iter = optim.get("test_iter", 100) * 100
    val_poses = []
    for i in range(cfg.get("start", 0), images.shape[0]):
        pose_i = poses_gt[i]
        if test_photo:
            draw = (tt_draws(i) if tt_draws is not None else
                    pixel_draws(tcfg.rand_rays, H * W,
                                torch.Generator(device=device).manual_seed(seed * 100003 + i),
                                device))
            t0 = time.perf_counter()
            res = test_time_pose_optim(
                photometric_loss(tcfg, state.params, pose_i, intr[i], images[i], H, W), draw,
                lr=tcfg.lr_pose / 2, max_iter=max_iter, stop_loss=TT_STOP_LOSS, device=device)
            n = int(res.n_iters)
            ms = 1e3 * (time.perf_counter() - t0) / max(n, 1)
            pose_i = pose_lib.compose_pair(lie.se3_to_SE3(res.se3)[0], pose_i)
            writer.quant_line("loss.txt", float(res.loss), n)
            log.info(f"view {i}: test-time optimisation {n} iterations ({res.reason}), "
                     f"loss {float(res.loss):.6f}, {ms:.3f} ms per iteration")
        val_poses.append(pose_i)
        rgb, _ = nt.render_validation(tcfg, state.params, pose_i, intr[i], H, W)
        p = float(psnr(rgb, images[i]))
        writer.quant_line("quant.txt", i, p)
        log.info(f"view {i}: psnr {p:.2f}")
        save_image(os.path.join(out_dir, f"rgb_{i}"), torch.clamp(rgb, 0, 1).cpu().numpy())

    if tcfg.refine_pose and val_poses:
        pose_export.write_transforms_json(os.path.join(out_dir, "transform_val.json"),
                                          torch.stack(val_poses), file_pattern="./val/r_{}")
        log.info(f"val pose export -> {out_dir}/transform_val.json")

    if cfg.get("video"):
        # novel views along a small orbit around view 0 (nerf.py:160-199)
        from ..evaluation.visualization import visualize_depth, write_video

        novel = pose_lib.get_novel_view_poses(poses_gt[0], N=cfg.get("video_frames", 30))
        rgb_frames, depth_frames = [], []
        for k in range(novel.shape[0]):
            rgb, depth = nt.render_validation(tcfg, state.params, novel[k], intr[0], H, W)
            rgb_frames.append(torch.clamp(rgb, 0, 1).cpu().numpy())
            dimg, _ = visualize_depth(1.0 / np.maximum(depth.cpu().numpy(), 1e-3))
            depth_frames.append(dimg)
        v1 = write_video(os.path.join(out_dir, "novel_view_rgb.mp4"), rgb_frames, fps=10)
        v2 = write_video(os.path.join(out_dir, "novel_view_invdepth.mp4"), depth_frames, fps=10)
        log.info(f"videos -> {v1}, {v2}")
    return out_dir


if __name__ == "__main__":
    main()
