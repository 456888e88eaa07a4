"""Instant-NGP CLI, render tasks (counterpart of myc_nerfs_tpu/cli/run_net.py).

``python -m myc_nerfs_tpu_torch.cli.run_net --config-file <cfg.py>
--task test|render [--save_dir d] [--synthetic] [--device cuda]`` with the
same python-module configs as the JAX package (jnerf tools/run_net.py).

- ``--task test`` renders the eval views, writes ``test/r_<i>.npy`` (and a
  PNG when PIL is installed) and appends the mean PSNR to ``psnr.txt``.
- ``--task render`` renders ``render_frames`` views along the spherical
  path into ``demo/``.
- ``--task train`` is not ported yet and exits with an error.

With ``load_ckpt = True`` in the config, ``<save_dir>/model.ckpt`` (a JAX
package checkpoint) is restored first.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..core import components  # noqa: F401  (registers the type= factories)
from ..core.checkpoint import latest_checkpoint, restore_checkpoint
from ..core.config import init_cfg, load_config
from ..core.registry import (ENCODERS, LOSSES, NETWORKS, OPTIMS, SAMPLERS,
                             SCHEDULERS, build_from_cfg)
from ..geom.camera_path import path_spherical
from ..render.ngp_render import NGPRenderConfig
from ..train.ngp_trainer import NGPTrainConfig, NGPTrainer
from ..utils.metrics import psnr

SCALE, OFF = 0.33, 0.5  # synthetic scenes: world -> NGP box


def build_trainer(cfg, generator: torch.Generator, device=None,
                  camera_c2w=None, focal=None, image_wh=None):
    """Assemble the NGP pipeline from the config's ``type=`` keys through
    the registries (jnerf runner.py:16-60). Returns (trainer, train cfg)."""
    ds_cfg = cfg.get("dataset", {}).get("train", {})
    aabb_scale = ds_cfg.get("aabb_scale", 1)
    enc_cfg = dict(cfg.get("encoder", {}).get(
        "pos_encoder", {"type": "HashEncoder"}))
    enc_cfg.update(cfg.get("hash_grid_overrides", {}))
    grid = build_from_cfg(enc_cfg, ENCODERS, aabb_scale=aabb_scale)
    dir_cfg = cfg.get("encoder", {}).get("dir_encoder")
    dir_enc = build_from_cfg(dict(dir_cfg), ENCODERS) if dir_cfg else None
    mcfg = build_from_cfg(dict(cfg.get("model", {"type": "NGPNetworks"})),
                          NETWORKS, grid=grid, dir_encoder=dir_enc,
                          use_bf16=cfg.get("fp16", False),
                          grid_impl=cfg.get("grid_impl", "brick3"))
    rcfg = NGPRenderConfig(
        aabb_scale=aabb_scale,
        n_coarse=cfg.get("n_coarse", 512),
        n_samples=cfg.get("n_samples", 64),
        near_distance=cfg.get("near_distance", 0.2),
        cone_angle_constant=cfg.get("cone_angle_constant", 0.00390625),
        const_dt=cfg.get("const_dt", True),
        # scale-aware march budget, as the JAX run_net: 20 at aabb_scale<=1,
        # 64 for cascaded scenes
        n_compact=cfg.get("n_compact", 20 if aabb_scale <= 1 else 64),
        fused_march=cfg.get("fused_march", True),
        early_stop_eps=cfg.get("early_stop_eps", 1e-4))
    sampler = build_from_cfg(dict(cfg.get(
        "sampler", {"type": "DensityGridSampler"})), SAMPLERS)
    optim = build_from_cfg(dict(cfg.get("optim", {"type": "Adam"})), OPTIMS)
    exp = build_from_cfg(dict(cfg.get("expdecay", {"type": "ExpDecay"})),
                         SCHEDULERS)
    ema = build_from_cfg(dict(cfg.get("ema", {"type": "EMA"})), OPTIMS)
    loss_fn = build_from_cfg(dict(cfg.get("loss", {"type": "HuberLoss"})),
                             LOSSES)
    tcfg = NGPTrainConfig(
        lr=optim["lr"], eps=optim["eps"], betas=optim["betas"],
        ema_decay=ema["decay"],
        decay_start=exp["decay_start"],
        decay_interval=exp["decay_interval"],
        decay_base=exp["decay_base"],
        n_rays_per_batch=cfg.get("n_rays_per_batch", 4096),
        target_batch_size=cfg.get("target_batch_size", 1 << 18),
        update_den_freq=sampler["update_den_freq"],
        background_color=tuple(cfg.get("background_color", (1, 1, 1))),
        tot_train_steps=cfg.get("tot_train_steps", 40000),
        n_grid_uniform=cfg.get("n_grid_uniform", 1 << 16),
        n_grid_nonuniform=cfg.get("n_grid_nonuniform", 1 << 16),
        skip_nonfinite=cfg.get("skip_nonfinite", bool(cfg.get("fp16", False))),
        fp16_grads=cfg.get("fp16_grads", bool(cfg.get("fp16", False))),
        # staged march budget at aabb_scale<=1: 20 until decay_start, 32 after
        n_compact_schedule=cfg.get(
            "n_compact_schedule",
            (((0, 20), (exp["decay_start"], 32))
             if ("n_compact" not in cfg and aabb_scale <= 1
                 and cfg.get("tot_train_steps", 40000) > exp["decay_start"])
             else None)))
    trainer = NGPTrainer(mcfg, rcfg, tcfg, generator, device=device,
                         camera_c2w=camera_c2w, focal=focal,
                         image_wh=image_wh, loss_fn=loss_fn)
    return trainer, tcfg


def _synthetic_scene(cfg):
    """The synthetic scene of run_net's data-free mode, built once per cfg
    (train views first, then ``synthetic_val_views`` held-out views)."""
    scene = cfg.get("_synthetic_scene_obj")
    if scene is not None:
        return scene
    from ..data import synthetic as syn

    if cfg.get("synthetic_scene", "blobs") != "blobs":
        raise ValueError("only the 'blobs' synthetic scene is ported")
    H = W = cfg.get("synthetic_size", 24)
    n = cfg.get("synthetic_views", 10) + cfg.get("synthetic_val_views", 0)
    scene = syn.make_scene(n_views=n, H=H, W=W)
    cfg["_synthetic_scene_obj"] = scene
    return scene


def load_data(cfg):
    """(focal, H, W) of the ``--synthetic`` scene's cameras."""
    if not cfg.get("synthetic"):
        raise NotImplementedError("only --synthetic data is ported; the "
                                  "blender loader arrives with training")
    scene = _synthetic_scene(cfg)
    return float(scene.intr[0, 0, 0]), scene.H, scene.W


def load_eval_views(cfg):
    """Eval views -> (images, c2w list (NGP space), intr list): the
    held-out views when configured, else the first train views."""
    if not cfg.get("synthetic"):
        raise NotImplementedError("only --synthetic eval views are ported")
    scene = _synthetic_scene(cfg)
    n_train = cfg.get("synthetic_views", 10)
    n_val = cfg.get("synthetic_val_views", 0)
    idx = range(n_train, n_train + n_val) if n_val else range(min(4, n_train))
    c2ws, intrs, imgs = [], [], []
    for i in idx:
        R, t = scene.poses[i][:, :3], scene.poses[i][:, 3]
        c2ws.append(torch.cat([R.T, (-R.T @ t[:, None]) * SCALE + OFF], 1))
        intrs.append(scene.intr[i])
        imgs.append(scene.images[i].numpy())
    return np.asarray(imgs), c2ws, intrs


def path_pose(c2w_nerf) -> torch.Tensor:
    """A path_spherical pose (NeRF convention, -z forward, +y up) in the
    renderer's convention (+z forward, y down): flip the y and z camera
    axes. The JAX run_net hands the NeRF pose to the renderer as it is, so
    its frames look away from the scene."""
    c2w = torch.as_tensor(c2w_nerf, dtype=torch.float32).clone()
    c2w[:, 1:3] *= -1.0
    return c2w


def _save_frame(path_stem: str, rgb: np.ndarray) -> None:
    """rgb [H, W, 3] in [0, 1] -> <stem>.npy, and <stem>.png when PIL is
    installed."""
    np.save(path_stem + ".npy", rgb)
    try:
        from PIL import Image
    except ImportError:
        return
    Image.fromarray((rgb * 255).astype(np.uint8)).save(path_stem + ".png")


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--task", default="train",
                        choices=["train", "test", "render"])
    parser.add_argument("--save_dir", default="")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda when available)")
    args = parser.parse_args(argv)
    if args.task == "train":
        raise SystemExit("--task train is not yet ported to myc_nerfs_tpu_torch; "
                         "train with myc_nerfs_tpu.cli.run_net and render "
                         "its checkpoint here")

    device = torch.device(args.device or
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    cfg = load_config(args.config_file)
    if args.synthetic:
        cfg["synthetic"] = True
    init_cfg(cfg)
    out_dir = args.save_dir or os.path.join(cfg.get("log_dir", "./logs"),
                                            cfg.get("exp_name", "run"))
    os.makedirs(out_dir, exist_ok=True)

    focal, H, W = load_data(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    trainer, _ = build_trainer(cfg, gen, device=device)
    ckpt = os.path.join(out_dir, "model.ckpt")
    if cfg.get("load_ckpt") and latest_checkpoint(out_dir):
        trainer.state, meta = restore_checkpoint(ckpt, trainer.state)
        # a restore also restores the march schedule's stage
        trainer.set_host_step(meta.get("step", trainer.state.step))
        print(f"resumed @ {meta.get('step')}")

    if args.task == "test":
        images, c2ws, intrs = load_eval_views(cfg)
        test_dir = os.path.join(out_dir, "test")
        os.makedirs(test_dir, exist_ok=True)
        psnrs = []
        for i in range(len(c2ws)):
            rgb, _ = trainer.render_image(c2ws[i], intrs[i], H, W)
            arr = torch.clamp(rgb, 0, 1).cpu().numpy()
            _save_frame(os.path.join(test_dir, f"r_{i}"), arr)
            p = float(psnr(torch.from_numpy(arr), torch.from_numpy(images[i])))
            psnrs.append(p)
            print(f"test view {i}: psnr {p:.2f}")
        with open(os.path.join(out_dir, "psnr.txt"), "a") as f:
            f.write(f"mean {float(np.mean(psnrs))}\n")
        print(f"TOTAL PSNR: {float(np.mean(psnrs)):.3f}")
    else:
        intr = torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
        frame_dir = os.path.join(out_dir, "demo")
        os.makedirs(frame_dir, exist_ok=True)
        for i, c2w in enumerate(path_spherical(cfg.get("render_frames", 8))):
            rgb, _ = trainer.render_image(path_pose(c2w), intr, H, W)
            _save_frame(os.path.join(frame_dir, f"{i:03d}"),
                        torch.clamp(rgb, 0, 1).cpu().numpy())
        print(f"render -> {frame_dir}")
    return out_dir


if __name__ == "__main__":
    main()
