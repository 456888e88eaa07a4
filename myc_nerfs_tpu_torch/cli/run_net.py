"""Instant-NGP CLI (counterpart of myc_nerfs_tpu/cli/run_net.py).

``python -m myc_nerfs_tpu_torch.cli.run_net --config-file <cfg.py>
--task train|test|render [--save_dir d] [--synthetic] [--steps N]
[--device cuda|cpu]`` with the same python-module configs as the JAX
package (jnerf tools/run_net.py). It runs on the card unless ``--device
cpu`` is given, and exits with an error where CUDA is not available.

- ``--task train`` runs ``train_loop`` (the JAX run_net loop) to
  ``tot_train_steps`` (or ``--steps``) and saves ``model.ckpt`` in the JAX
  package's format (core/checkpoint.py's own msgpack codec).
- ``--task test`` renders the eval views, writes ``test/r_<i>.npy`` (and a
  PNG when PIL is installed) and appends the mean PSNR to ``psnr.txt``.
- ``--task render`` renders ``render_frames`` views along the spherical
  path into ``demo/``.

With ``load_ckpt = True`` in the config, ``<save_dir>/model.ckpt`` (the JAX
package's or the port's) is restored first. Configs with ``model =
dict(type="OriginNeRFNetworks")`` (configs/nerf/*.py) train an
OriginNeRFModel through the same loop; ``--synthetic`` scenes are
'blobs' (default), 'detail' and 'cascade' (``synthetic_scene``).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import components  # noqa: F401  (registers the type= factories)
from ..core.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..core.config import init_cfg, load_config
from ..core.registry import (ENCODERS, LOSSES, NETWORKS, OPTIMS, SAMPLERS,
                             SCHEDULERS, build_from_cfg)
from ..data.synthetic import OFF, SCALE  # synthetic scenes: world -> NGP box
from ..evaluation.visualization import save_image
from ..geom.camera_path import path_spherical
from ..models.ori_nerf import OriginNeRFConfig, OriginNeRFModel
from ..render.ngp_render import NGPRenderConfig
from ..train.ngp_trainer import NGPTrainConfig, NGPTrainer
from ..utils.metrics import psnr

# val-render cadence during training (runner.py:80-84 renders a val image
# every 4096 steps); module-level so tests can shrink it
VAL_EVERY = 4096


def build_trainer(cfg, generator: torch.Generator, device="cuda",
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
    # OriginNeRFNetworks (projects/nerf) pairs the frequency-encoded MLP
    # with the same sampler pipeline: the trainer takes it as its model
    model = (OriginNeRFModel(mcfg, device=device, generator=generator)
             if isinstance(mcfg, OriginNeRFConfig) else None)
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
                         image_wh=image_wh, loss_fn=loss_fn, model=model)
    return trainer, tcfg


def _synthetic_scene(cfg, device=None):
    """The synthetic scene of run_net's data-free mode, built once per cfg
    (train views first, then ``synthetic_val_views`` held-out views):
    ``synthetic_scene`` 'blobs' (default), 'detail' (the quality runs'
    256^2 field) or 'cascade' (content outside the unit box, four rings;
    views a multiple of 4). ``device`` renders the ground truth there."""
    scene = cfg.get("_synthetic_scene_obj")
    if scene is not None:
        return scene
    from ..data import synthetic as syn

    H = W = cfg.get("synthetic_size", 24)
    n = cfg.get("synthetic_views", 10) + cfg.get("synthetic_val_views", 0)
    kind = cfg.get("synthetic_scene", "blobs")
    if kind == "detail":
        scene = syn.make_detail_scene(n_views=n, H=H, W=W, device=device)
    elif kind == "cascade":
        scene = syn.make_cascade_scene(n_views=n, H=H, W=W, device=device)
    elif kind == "blobs":
        scene = syn.make_scene(n_views=n, H=H, W=W)
    else:
        raise ValueError(f"unknown synthetic_scene {kind!r}: "
                         "'blobs', 'detail' or 'cascade'")
    cfg["_synthetic_scene_obj"] = scene
    return scene


def load_data(cfg, device=None):
    """(training data, H, W): the ``--synthetic`` scene's train views
    (SyntheticNGPData; ``device`` renders its ground truth) or the
    config's blender dataset (NGPDataset, train and val JSONs merged)."""
    if cfg.get("synthetic"):
        from ..data.synthetic import SyntheticNGPData

        scene = _synthetic_scene(cfg, device)
        return (SyntheticNGPData(scene, cfg.get("synthetic_views", 10)),
                scene.H, scene.W)
    from ..data import blender

    ds_cfg = cfg.get("dataset", {}).get("train", {})
    ds = blender.load_ngp_train_data(
        ds_cfg.get("root_dir", "data"), aabb_scale=ds_cfg.get("aabb_scale", 1),
        scale=ds_cfg.get("scale"), offset=ds_cfg.get("offset"),
        correct_pose=tuple(ds_cfg.get("correct_pose", (-1, -1, 1))))
    return ds, ds.H, ds.W


def load_eval_views(cfg):
    """Eval views -> (images or None, c2w list (NGP space), intr list): the
    synthetic scene's held-out views when configured, else its first train
    views; for blender data the val split."""
    if cfg.get("synthetic"):
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
    from ..data import blender

    ds_cfg = cfg.get("dataset", {}).get("val", cfg.get("dataset", {}).get("train", {}))
    scene = blender.load_blender_split(ds_cfg.get("root_dir", "data"), "val",
                                       require_images=False)
    ds = blender.NGPDataset.from_scene(
        scene, aabb_scale=ds_cfg.get("aabb_scale", 1),
        scale=ds_cfg.get("scale"), offset=ds_cfg.get("offset"),
        correct_pose=tuple(ds_cfg.get("correct_pose", (-1, -1, 1))))
    intr = np.asarray([[scene.focal, 0, scene.W / 2],
                       [0, scene.focal, scene.H / 2], [0, 0, 1.0]], np.float32)
    imgs = blender.blend_background(scene) if scene.images.shape[0] else None
    return imgs, [torch.from_numpy(m) for m in ds.c2w_ngp], \
        [torch.from_numpy(intr)] * ds.c2w_ngp.shape[0]


def train_loop(trainer: NGPTrainer, tcfg: NGPTrainConfig, data, steps: int,
               generator: torch.Generator, cfg=None, out_dir: Optional[str] = None,
               H: int = 0, W: int = 0, log=print) -> List[Dict[str, torch.Tensor]]:
    """Train until ``steps`` (jnerf Runner.train; the JAX run_net loop).

    Blocks of update_den_freq steps, each after one occupancy-grid update;
    per-ray random backgrounds for RGBA data (runner.py:66-68), the pinned
    background of pre-composited data; the batch adapts toward
    target_batch_size samples after every block. With ``out_dir`` (and the
    config, for the eval views), every VAL_EVERY steps one eval view's PSNR
    goes to psnr.txt and model.ckpt is saved, and it is saved at the end.
    Returns each block's metrics (train_block's, on the device)."""
    from ..data.blender import RayBatcher

    ckpt = os.path.join(out_dir, "model.ckpt") if out_dir else None
    batcher = RayBatcher(data.n_images, data.n_pixels, trainer.n_rays_per_batch)
    rng = np.random.default_rng(0)
    fixed_bg = getattr(data, "fixed_bg", None)
    S = tcfg.update_den_freq
    it = trainer.state.step
    val_views = None
    history = []
    while it < steps:
        if batcher.batch != trainer.n_rays_per_batch:
            batcher = RayBatcher(data.n_images, data.n_pixels,
                                 trainer.n_rays_per_batch, seed=it)
        trainer.state = trainer.state._replace(
            occ=trainer.grid_update(trainer.state.occ, generator))
        s = min(S, steps - it)
        os_, ds_, ts_, bgs = [], [], [], []
        for _ in range(s):
            img_ids, pix_ids = batcher.next()
            o, d = data.rays_for_pixels(img_ids, pix_ids)
            bg = (np.tile(np.asarray(fixed_bg, np.float32), (len(img_ids), 1))
                  if fixed_bg is not None
                  else rng.uniform(0, 1, (len(img_ids), 3)).astype(np.float32))
            ts_.append(data.pixel_values(img_ids, pix_ids, bg=bg))
            bgs.append(bg)
            os_.append(o)
            ds_.append(d)
        m = trainer.train_block(np.stack(os_), np.stack(ds_), np.stack(ts_),
                                bg=np.stack(bgs), generator=generator)
        trainer._update_batch_rays()
        it += s
        history.append(m)
        if (it // S) % max(1, 100 // S) == 0:
            log(f"step {it} psnr {float(m['psnr'][-1]):.2f} "
                f"rays/batch {trainer.n_rays_per_batch}")
        if ckpt and it % VAL_EVERY < S and it >= VAL_EVERY:
            if val_views is None:
                val_views = load_eval_views(cfg)
            imgs, c2ws, intrs = val_views
            if imgs is not None and len(c2ws):
                rgb, _ = trainer.render_image(c2ws[0], intrs[0], H, W)
                p = float(psnr(torch.clamp(rgb, 0, 1).cpu(), torch.from_numpy(imgs[0])))
                with open(os.path.join(out_dir, "psnr.txt"), "a") as f:
                    f.write(f"{it} {p}\n")
                log(f"step {it} val psnr {p:.2f}")
            save_checkpoint(ckpt, trainer.state, step=it)
    if ckpt:
        save_checkpoint(ckpt, trainer.state, step=steps)
        log(f"saved {ckpt}")
    return history


def path_pose(c2w_nerf) -> torch.Tensor:
    """A path_spherical pose (NeRF convention, -z forward, +y up) in the
    renderer's convention (+z forward, y down): flip the y and z camera
    axes. The JAX run_net hands the NeRF pose to the renderer as it is, so
    its frames look away from the scene."""
    c2w = torch.as_tensor(c2w_nerf, dtype=torch.float32).clone()
    c2w[:, 1:3] *= -1.0
    return c2w


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--task", default="train",
                        choices=["train", "test", "render"])
    parser.add_argument("--save_dir", default="")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=0,
                        help="override tot_train_steps")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; pass --device cpu "
                             "to run on the CPU)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is "
                         "false; pass --device cpu to run on the CPU")
    cfg = load_config(args.config_file)
    if args.synthetic:
        cfg["synthetic"] = True
    init_cfg(cfg)
    out_dir = args.save_dir or os.path.join(cfg.get("log_dir", "./logs"),
                                            cfg.get("exp_name", "run"))
    os.makedirs(out_dir, exist_ok=True)

    data, H, W = load_data(cfg, device)
    # the dataset's cameras let mark_untrained blank never-seen cells
    cam_kw = {}
    if hasattr(data, "c2w_ngp"):
        cam_kw = {"camera_c2w": torch.from_numpy(data.c2w_ngp),
                  "focal": torch.from_numpy(data.focal), "image_wh": (W, H)}
    gen = torch.Generator(device=device).manual_seed(0)
    trainer, tcfg = build_trainer(cfg, gen, device=device, **cam_kw)
    ckpt = os.path.join(out_dir, "model.ckpt")
    if cfg.get("load_ckpt") and latest_checkpoint(out_dir):
        trainer.state, meta = restore_checkpoint(ckpt, trainer.state)
        # a restore also restores the march schedule's stage
        trainer.set_host_step(meta.get("step", trainer.state.step))
        print(f"resumed @ {meta.get('step')}")

    if args.task == "train":
        train_loop(trainer, tcfg, data, args.steps or tcfg.tot_train_steps, gen,
                   cfg=cfg, out_dir=out_dir, H=H, W=W)
    elif args.task == "test":
        images, c2ws, intrs = load_eval_views(cfg)
        test_dir = os.path.join(out_dir, "test")
        os.makedirs(test_dir, exist_ok=True)
        psnrs = []
        for i in range(len(c2ws)):
            rgb, _ = trainer.render_image(c2ws[i], intrs[i], H, W)
            arr = torch.clamp(rgb, 0, 1).cpu().numpy()
            save_image(os.path.join(test_dir, f"r_{i}"), arr)
            if images is not None:
                p = float(psnr(torch.from_numpy(arr), torch.from_numpy(images[i])))
                psnrs.append(p)
                print(f"test view {i}: psnr {p:.2f}")
        if psnrs:
            with open(os.path.join(out_dir, "psnr.txt"), "a") as f:
                f.write(f"mean {float(np.mean(psnrs))}\n")
            print(f"TOTAL PSNR: {float(np.mean(psnrs)):.3f}")
    else:
        focal = float(np.asarray(data.focal).reshape(-1)[0])
        intr = torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
        frame_dir = os.path.join(out_dir, "demo")
        os.makedirs(frame_dir, exist_ok=True)
        for i, c2w in enumerate(path_spherical(cfg.get("render_frames", 8))):
            rgb, _ = trainer.render_image(path_pose(c2w), intr, H, W)
            save_image(os.path.join(frame_dir, f"{i:03d}"),
                       torch.clamp(rgb, 0, 1).cpu().numpy())
        print(f"render -> {frame_dir}")
    return out_dir


if __name__ == "__main__":
    main()
