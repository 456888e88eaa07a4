"""BARF-family training CLI: nerf, barf, garf (counterpart of
myc_nerfs_tpu/cli/train.py; barf train.py + options.py).

    python -m myc_nerfs_tpu_torch.cli.train --model=garf --yaml=configs/barf/Easyship.yaml \\
        [--data.root=/path/to/Easyship] [--max_iter_run=N] [--device=cpu]

YAML configs with ``_parent_`` chains (read without a yaml package) and
dot-path overrides (``--optim.lr=1e-4``, ``--flag``, ``--flag!``). It trains
with the config's cadences of scalars (``freq.scalar``, with the pose errors
for barf and garf), validation renders (``freq.val``) and checkpoints
(``freq.ckpt``, ``model.ckpt`` plus ``model/<step>.ckpt``) up to
``max_iter_run`` (default ``max_iter``), resumes from ``model.ckpt`` with
``--resume``, and for barf and garf writes the refined training poses to
``transform_train.json`` at the end. Output goes to
``<output_root>/<group>/<name>``.

It runs on the card unless the config key ``device`` says otherwise
(``--device=cpu``), and exits with an error where CUDA is not available.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..core.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from ..core.config import Config, apply_overrides, load_config
from ..evaluation import pose_eval, pose_export
from ..train import nerf_trainer as nt
from ..utils.logging import ETATimer, MetricWriter, log
from ..utils.metrics import psnr


def config_to_train_config(cfg: Config) -> nt.NeRFTrainConfig:
    """Reference-style YAML keys (arch.*, nerf.*, optim.*, camera.*) ->
    NeRFTrainConfig (options/nerf_blender.yaml)."""
    arch = cfg.get("arch", {})
    nerf = cfg.get("nerf", {})
    optim = cfg.get("optim", {})
    camera = cfg.get("camera", {})
    model = cfg.get("model", "nerf")
    posenc = arch.get("posenc") or {}
    layers_feat = arch.get("layers_feat", [None] + [256] * 8)
    layers_rgb = arch.get("layers_rgb", [None, 128, 3])
    return nt.NeRFTrainConfig(
        model=model,
        widths_feat=tuple(layers_feat[1:]),
        widths_rgb=tuple(layers_rgb[1:]),
        skip=tuple(arch.get("skip", [4])),
        posenc_L3D=(posenc.get("L_3D") if model != "garf" else None),
        posenc_Lview=(posenc.get("L_view") if model != "garf" else None),
        density_activ=arch.get("density_activ", "softplus"),
        view_dep=nerf.get("view_dep", True),
        depth_range=tuple(nerf.get("depth", {}).get("range", [2.0, 6.0])),
        sample_intvs=nerf.get("sample_intvs", 128),
        sample_stratified=nerf.get("sample_stratified", True),
        fine_sampling=nerf.get("fine_sampling", False),
        sample_intvs_fine=nerf.get("sample_intvs_fine") or 0,
        rand_rays=nerf.get("rand_rays", 2048),
        density_noise_reg=nerf.get("density_noise_reg") or 0.0,
        setbg_opaque=nerf.get("setbg_opaque", False),
        bgcolor=cfg.get("data", {}).get("bgcolor", 1.0),
        refine_pose=(model in ("barf", "garf")),
        c2f=(tuple(cfg["barf_c2f"]) if cfg.get("barf_c2f") else None),
        camera_noise=camera.get("noise") or 0.0,
        start_pose_correct_iter=cfg.get("start_pose_correct_iter", 0),
        lr=optim.get("lr", 5e-4),
        lr_end=optim.get("lr_end", 1e-4),
        lr_pose=optim.get("lr_pose", 3e-3),
        lr_pose_end=optim.get("lr_pose_end", 1e-5),
        warmup_pose=optim.get("warmup_pose") or 0,
        max_iter=cfg.get("max_iter", 200000),
    )


def load_views(cfg: Config):
    """(images [N, H, W, 3], poses [N, 3, 4], intr [N, 3, 3], H, W), tensors
    on the CPU: the synthetic scene (``data.synthetic``: ``n_views``,
    ``image_size``, ``textured``) or a blender directory (``data.root``, else
    ``data.data_root``/``data.scene``)."""
    data = cfg.get("data", {})
    if data.get("synthetic"):
        from ..data.synthetic import make_scene

        H = W = data.get("image_size", [32, 32])[0]
        scene = make_scene(n_views=data.get("n_views", 10), H=H, W=W,
                           textured=data.get("textured", False))
        return scene.images, scene.poses, scene.intr, H, W
    from ..data import blender

    root = data.get("root") or os.path.join(data.get("data_root", "data"),
                                            data.get("scene", ""))
    scene = blender.load_blender_split(root, data.get("split", "train"),
                                       downsample=data.get("downsample", 1.0))
    images, poses, intr = blender.barf_views(scene, bg=data.get("bgcolor", 1.0))
    return (torch.from_numpy(images), torch.from_numpy(poses), torch.from_numpy(intr),
            scene.H, scene.W)


def pose_errors(tcfg: nt.NeRFTrainConfig, state: nt.NeRFTrainState, poses: torch.Tensor):
    """Mean rotation (radians) and translation errors of the refined poses
    against ``poses`` after Procrustes alignment (on the CPU)."""
    refined = nt.compose_refined_pose(tcfg, state, poses).cpu()
    aligned, _ = pose_eval.prealign_cameras(refined, poses.cpu())
    err = pose_eval.evaluate_camera_alignment(aligned, poses.cpu())
    return float(err.R.mean()), float(err.t.mean())


def load_run_config(argv: List[str]) -> Config:
    """The config of a command line: ``--yaml=`` loaded, ``--model=`` set,
    then every other ``--a.b=v`` applied (new keys allowed)."""
    model_arg = [a for a in argv if a.startswith("--model=")]
    yaml_arg = [a for a in argv if a.startswith("--yaml=")]
    rest = [a for a in argv if not (a.startswith("--model=") or a.startswith("--yaml="))]
    cfg = load_config(yaml_arg[0].split("=", 1)[1]) if yaml_arg else Config()
    if model_arg:
        cfg["model"] = model_arg[0].split("=", 1)[1]
    return apply_overrides(cfg, rest, strict=False)


def main(argv: Optional[List[str]] = None) -> str:
    cfg = load_run_config(list(sys.argv[1:] if argv is None else argv))
    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device}: torch.cuda.is_available() is false; "
                         "pass --device=cpu to run on the CPU")

    out_dir = os.path.join(cfg.get("output_root", "output"),
                           cfg.get("group", "default"), cfg.get("name", "run"))
    os.makedirs(out_dir, exist_ok=True)
    writer = MetricWriter(out_dir, use_tb=cfg.get("tb", False))
    log.title(f"training {cfg.get('model', 'nerf')} on {device} -> {out_dir}")

    images, poses, intr, H, W = (x.to(device) if torch.is_tensor(x) else x
                                 for x in load_views(cfg))
    tcfg = config_to_train_config(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.get("seed", 0))
    n_images = images.shape[0]
    state = nt.init_state(tcfg, gen, n_images, device)

    ckpt_path = os.path.join(out_dir, "model.ckpt")
    start_iter = 0
    if cfg.get("resume") and latest_checkpoint(out_dir):
        state, meta = restore_checkpoint(ckpt_path, state)
        start_iter = int(meta.get("step", 0))
        log.info(f"resumed from iter {start_iter}")

    step = nt.make_train_step(tcfg, images, poses, intr)
    freq = cfg.get("freq", {})
    val_every = freq.get("val", 2000)
    ckpt_every = freq.get("ckpt", 5000)
    scalar_every = freq.get("scalar", 200)
    max_iter = cfg.get("max_iter_run", tcfg.max_iter)
    timer = ETATimer()
    for it in range(start_iter, max_iter):
        state, metrics = step(state, nt.draw_step(tcfg, n_images, H, W, gen, device))
        if scalar_every and it % scalar_every == 0:
            loss, train_psnr = float(metrics["loss"]), float(metrics["psnr"])
            if not np.isfinite(loss):
                raise RuntimeError(f"loss is not finite at iter {it}")
            eta = timer.update(it, max_iter)
            writer.scalar("train/loss", loss, it)
            writer.scalar("train/psnr", train_psnr, it)
            log.info(f"it {it} loss {loss:.5f} psnr {train_psnr:.2f} eta {eta / 60:.1f} min")
            if tcfg.refine_pose:
                err_R, err_t = pose_errors(tcfg, state, poses)
                writer.scalar("train/error_R", err_R, it)
                writer.scalar("train/error_t", err_t, it)
        if val_every and it % val_every == val_every - 1:
            rgb, _ = nt.render_validation(tcfg, state.params, poses[0], intr[0], H, W)
            writer.scalar("val/psnr", float(psnr(rgb, images[0])), it)
        if ckpt_every and it % ckpt_every == ckpt_every - 1:
            save_checkpoint(ckpt_path, state, step=it + 1, keep_snapshot=True)

    save_checkpoint(ckpt_path, state, step=max_iter)
    if tcfg.refine_pose:
        refined = nt.compose_refined_pose(tcfg, state, poses)
        pose_export.write_transforms_json(os.path.join(out_dir, "transform_train.json"),
                                          refined)
        log.info(f"pose export -> {out_dir}/transform_train.json")
    log.info("done")
    return out_dir


if __name__ == "__main__":
    main()
