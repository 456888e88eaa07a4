"""TensoRF on the port (counterpart of myc_nerfs_tpu/cli/tensorf_train.py;
tensorf-myc opt.py + train.py):

    python -m myc_nerfs_tpu_torch.cli.tensorf_train --config configs/tensorf/Coffee.txt
        [--render_only 1 [--render_path 1]] [--export_mesh 1] [--resume 1]
        [--ckpt F] [--synthetic [--textured]] [--n_iters N] [--device cpu]

"key = value" config files; model_name TensorVMSplit | TensorVM | TensorCP |
REFTensoRF | NerfPlusPlus. Trains (or resumes), checkpoints to
``<basedir>/<expname>/<expname>.ckpt`` in the JAX package's format, renders
the test split (``--render_only``) with PSNR and SSIM, renders an orbit
(``--render_path``), or exports a mesh (``--export_mesh``). It runs on the
card unless ``--device cpu`` is given, and exits with an error where CUDA
is not available.

The JAX package's sample budgets and bf16 factor gather (TPU workarounds)
are parsed and not used: the port evaluates every gated sample exactly.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core.bridge import load_tensorf_params, tensorf_adam_from_numpy
from ..core.checkpoint import read_tensorf_checkpoint, save_tensorf_checkpoint
from ..models import nerfpp, ref_tensorf, tensorf as tfm
from ..train import tensorf_trainer as tt
from ..utils.logging import MetricWriter, log

# every txt key this CLI consumes (the reference's flag surface, opt.py:4-156);
# any other key gets a one-line note instead of being dropped silently
_KNOWN_KEYS = frozenset((
    "L1_weight_inital", "L1_weight_rest", "N_voxel_final", "N_voxel_init",
    "Ortho_weight", "TV_weight_app", "TV_weight_density", "alpha_mask_thre",
    "basedir", "batch_size", "bbox", "bg_D", "bg_freq", "bg_samples",
    "bg_view_freq", "data_dim_color", "datadir", "density_shift",
    "distance_scale", "downsample_test", "downsample_train", "expname",
    "app_sample_budget", "density_batch_budget",
    "density_sample_budget", "factor_gather_bf16",
    "far", "fea2denseAct", "fea_pe", "featureC",
    "global_step", "grid_size",
    "has_opt_state", "lr_basis", "lr_decay_iters", "lr_decay_target_ratio",
    "lr_init", "lr_scale", "lr_upsample_reset", "model_name", "nSamples",
    "n_iters", "n_lamb_sh", "n_lamb_sigma", "near", "near_far",
    "normal_vector_penalty_weight", "pos_pe", "radii", "render_path_frames",
    "rm_weight_mask_thre", "shadingMode", "step_ratio", "synthetic",
    "synthetic_size", "synthetic_views", "update_AlphaMask_list",
    "upsamp_list", "view_pe", "white_bkgd"))
# the JAX package's static-shape stand-ins for boolean indexing, and its
# bf16 gather: read, not used
_TPU_KEYS = ("density_sample_budget", "app_sample_budget", "density_batch_budget",
             "factor_gather_bf16")


def parse_txt_config(path: str) -> dict:
    """configargparse "key = value" files (tensorf-myc/configs/*.txt); a
    note for each key this CLI does not consume."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = [s.strip() for s in line.split("=", 1)]
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
            if k not in _KNOWN_KEYS:
                log.info(f"config key '{k}' is not consumed by this CLI (ignored)")
    return out


def build_configs(a: dict):
    """(TensoRFConfig, TensoRFTrainConfig) of a parsed config, with this
    CLI's defaults (step_ratio 0.5, not TensoRFConfig's 2.0)."""
    set_tpu = [k for k in _TPU_KEYS if k in a]
    if set_tpu:
        log.info(f"{', '.join(set_tpu)}: TPU sample budgets, not used here; the port "
                 "evaluates density and appearance at every gated sample exactly")
    model_cfg = tfm.TensoRFConfig(
        decomp={"TensorCP": "cp", "TensorVM": "vm"}.get(
            a.get("model_name", "TensorVMSplit"), "vm_split"),
        density_n_comp=tuple(a.get("n_lamb_sigma", [16, 16, 16])),
        app_n_comp=tuple(a.get("n_lamb_sh", [48, 48, 48])),
        app_dim=a.get("data_dim_color", 27),
        shading_mode=a.get("shadingMode", "MLP_Fea"),
        density_shift=a.get("density_shift", -10),
        alpha_mask_thres=a.get("alpha_mask_thre", 1e-3),
        distance_scale=a.get("distance_scale", 25),
        ray_march_weight_thres=a.get("rm_weight_mask_thre", 1e-4),
        pos_pe=a.get("pos_pe", 6), view_pe=a.get("view_pe", 6),
        fea_pe=a.get("fea_pe", 6), featureC=a.get("featureC", 128),
        step_ratio=a.get("step_ratio", 0.5),
        fea2dense=a.get("fea2denseAct", "softplus"),
        near_far=tuple(a.get("near_far", [a.get("near", 2.0), a.get("far", 6.0)])))
    train_cfg = tt.TensoRFTrainConfig(
        n_iters=a.get("n_iters", 30000),
        batch_size=a.get("batch_size", 4096),
        lr_init=a.get("lr_init", 0.02), lr_basis=a.get("lr_basis", 1e-3),
        lr_decay_iters=a.get("lr_decay_iters", -1),
        lr_decay_target_ratio=a.get("lr_decay_target_ratio", 0.1),
        lr_upsample_reset=bool(a.get("lr_upsample_reset", 1)),
        ortho_weight=a.get("Ortho_weight", 0.0),
        l1_weight_initial=a.get("L1_weight_inital", 0.0),
        l1_weight_rest=a.get("L1_weight_rest", 0.0),
        tv_weight_density=a.get("TV_weight_density", 0.0),
        tv_weight_app=a.get("TV_weight_app", 0.0),
        n_voxel_init=a.get("N_voxel_init", 100**3),
        n_voxel_final=a.get("N_voxel_final", 300**3),
        upsamp_list=tuple(a.get("upsamp_list", [2000, 3000, 4000, 5500, 7000])),
        update_alphamask_list=tuple(a.get("update_AlphaMask_list", [2000, 4000])),
        n_samples_cap=a.get("nSamples", 1_000_000),
        white_bg=bool(a.get("white_bkgd", True)))
    return model_cfg, train_cfg


def nerfpp_config(a: dict) -> nerfpp.NerfPPConfig:
    return nerfpp.NerfPPConfig(bg_freq=a.get("bg_freq", 4), bg_view_freq=a.get("bg_view_freq", 2),
                               bg_D=a.get("bg_D", 4), radii=a.get("radii", 20),
                               bg_samples=a.get("bg_samples", 512))


def build_family_trainer(a: dict, model_cfg, train_cfg, aabb,
                         generator: Optional[torch.Generator] = None, device="cuda"):
    """A TensoRFTrainer wired for ``a['model_name']``: the base forward for
    the decompositions; REFTensoRF's heads, forward and normal penalty
    (train.py:253-257); NerfPlusPlus's background net, forward and draws."""
    device = torch.device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    model_name = a.get("model_name", "TensorVMSplit")
    kw = {}
    if model_name == "REFTensoRF":
        w = a.get("normal_vector_penalty_weight", 0.0)
        kw = dict(forward_fn=lambda mc, g, p, b, r, d, white_bg: ref_tensorf.ref_tensorf_forward(
                      mc, g, p, b, r, d, white_bg=white_bg),
                  extra_loss_fn=lambda params, out: w * out.extras["penalty"])
    elif model_name == "NerfPlusPlus":
        pp = nerfpp_config(a)
        kw = dict(forward_fn=lambda mc, g, p, b, r, d, white_bg: nerfpp.nerfpp_forward(
                      mc, pp, g, p, b, r, d),
                  draw_fn=lambda trainer, n, gen_: (
                      torch.rand((n, trainer.geom.n_samples), generator=gen_,
                                 device=trainer.device),
                      torch.rand((n, pp.bg_samples), generator=gen_, device=trainer.device)))
    trainer = tt.TensoRFTrainer(model_cfg, train_cfg, aabb, gen, device, **kw)
    if model_name == "REFTensoRF":
        trainer.params = ref_tensorf.init_ref_heads(model_cfg, trainer.params, device, gen)
        trainer._rebuild(lr_scale=1.0)
    elif model_name == "NerfPlusPlus":
        trainer.params["bg_net"] = nerfpp.BgMLPNet(pp, device, gen)
        trainer._rebuild(lr_scale=1.0)
    return trainer


def _bbox(a: dict, default) -> np.ndarray:
    """The config's flat 6-list bbox as [2, 3] (configs/Scar.txt)."""
    return np.asarray(a.get("bbox", default), np.float32).reshape(2, 3)


def synthetic_scene(a: dict, textured: bool = False):
    from ..data.synthetic import make_scene

    H = W = a.get("synthetic_size", 20)
    return make_scene(n_views=a.get("synthetic_views", 10), H=H, W=W, textured=textured)


def load_rays(a: dict, device=None, textured: bool = False):
    """(rays [R, 6], rgbs [R, 3] on ``device``, aabb [2, 3], (H, W)) of the
    train split, or of the synthetic scene with ``synthetic``."""
    if a.get("synthetic"):
        scene = synthetic_scene(a, textured)
        rays = tt.build_ray_store(scene.poses, scene.intr, scene.H, scene.W)
        return (rays.to(device), scene.images.reshape(-1, 3).to(device),
                _bbox(a, [[-1.2] * 3, [1.2] * 3]), (scene.H, scene.W))
    from ..data import blender

    scene = blender.load_blender_split(a["datadir"], "train",
                                       downsample=a.get("downsample_train", 1.0))
    rays, rgbs = blender.tensorf_ray_store(scene, bg=1.0 if a.get("white_bkgd", True) else 0.0,
                                           device=device)
    return rays, rgbs, _bbox(a, [[-1.5] * 3, [1.5] * 3]), (scene.H, scene.W)


def save_tensorf_ckpt(ckpt: str, trainer, model_name: str) -> str:
    """The trainer's params, buffers and both Adams, with the stage (grid
    size, lr_scale, global_step) in the sidecar (train.py:147-164)."""
    return save_tensorf_checkpoint(ckpt, trainer, model_name)


def restore_tensorf_ckpt(ckpt: str, trainer, for_training: bool = False):
    """Rebuild the trainer at the checkpoint's stage, then load its weights,
    AABBs and alpha mask; ``for_training`` also restores both Adams,
    lr_scale, global_step and advances the voxel schedule past the upsamples
    done (train.py:147-164,186-190)."""
    tree, meta = read_tensorf_checkpoint(ckpt)
    gs = meta["grid_size"]
    trainer.params = tfm.upsample_volume_grid(trainer.model_cfg, trainer.params, gs)
    trainer.params = load_tensorf_params(trainer.params, tree["params"])
    dev = trainer.device
    trainer.buffers["aabb"] = torch.tensor(np.asarray(tree["aabb"], np.float32), device=dev)
    trainer.buffers["alpha_aabb"] = torch.tensor(np.asarray(tree["alpha_aabb"], np.float32),
                                                 device=dev)
    vol = np.asarray(tree["alpha_volume"], np.float32)
    trainer.buffers["alpha_volume"] = torch.tensor(vol, device=dev) if vol.size else None
    trainer.buffers = tfm.prepare_alpha_buffers(trainer.buffers)
    trainer.geom = tfm.compute_stage_geom(trainer.model_cfg, np.asarray(tree["aabb"]), gs,
                                          trainer.cfg.n_samples_cap)
    trainer._rebuild(lr_scale=meta.get("lr_scale", 1.0))
    if for_training:
        if meta.get("has_opt_state"):
            trainer.opt_spatial, trainer.opt_net = tensorf_adam_from_numpy(trainer.params,
                                                                           tree["opt_state"])
        trainer.set_step(int(meta.get("global_step", 0)))
        n_done = sum(1 for s in trainer.cfg.upsamp_list if s <= trainer.global_step)
        trainer.voxel_schedule = trainer.voxel_schedule[n_done:]
    return trainer


def _rays_fn(dirs, c2ws, device):
    from ..geom import rays as rays_lib

    def ray_fn(i):
        c2w = torch.as_tensor(np.asarray(c2ws[i][:3], np.float32), device=device)
        o, d = rays_lib.get_rays_from_directions(dirs, c2w)
        return torch.cat([o, d], -1)
    return ray_fn


def _resized_scene(scene, H: int, W: int):
    """A GT-less scene at H x W: the focal rescales with W (focal =
    0.5 W / tan(camera_angle_x / 2), dataLoader/blender.py:73)."""
    focal = 0.5 * W / np.tan(0.5 * scene.camera_angle_x)
    return dataclasses.replace(scene, H=H, W=W, focal=float(focal))


def render_test_split(a: dict, trainer, out_dir: str, fallback_hw=None):
    """render_test (train.py:62-106): the test split's poses into
    imgs_test_all/, PSNR and SSIM where images exist; GT-less splits at the
    train split's resolution."""
    from ..data import blender
    from ..geom import conventions, rays as rays_lib

    scene = blender.load_blender_split(a["datadir"], "test",
                                       downsample=a.get("downsample_test", 1.0),
                                       require_images=False)
    if scene.images.shape[0] == 0 and fallback_hw is not None:
        scene = _resized_scene(scene, *fallback_hw)
    H, W = scene.H, scene.W
    c2w_cv = conventions.blender2opencv(torch.as_tensor(np.asarray(scene.c2w, np.float32)))
    dirs = rays_lib.get_ray_directions(H, W, scene.focal, device=trainer.device)
    images = (blender.blend_background(scene, bg=1.0 if a.get("white_bkgd", True) else 0.0)
              if scene.images.shape[0] else None)
    psnrs, ssims = tt.evaluation(trainer, c2w_cv, None, images,
                                 os.path.join(out_dir, "imgs_test_all"), H=H, W=W,
                                 ray_fn=_rays_fn(dirs, c2w_cv.numpy(), trainer.device))
    if psnrs:
        log.info(f"render_test: mean psnr {np.mean(psnrs):.2f} ssim {np.mean(ssims):.4f}")
    else:
        log.info(f"render_test: {scene.c2w.shape[0]} GT-less test views -> "
                 f"{out_dir}/imgs_test_all")
    return psnrs, ssims


def render_novel_path(a: dict, trainer, out_dir: str, fallback_hw=None):
    """An orbit (camera_path.path_spherical) at the test split's focal
    length into imgs_path_all/ (renderer.py:91-148)."""
    from ..data import blender
    from ..geom import conventions
    from ..geom.camera_path import path_spherical

    scene = blender.load_blender_split(a["datadir"], "test", require_images=False)
    if scene.images.shape[0] == 0 and fallback_hw is not None:
        scene = _resized_scene(scene, *fallback_hw)
    orbit = path_spherical(a.get("render_path_frames", 40),
                           radius=float(np.linalg.norm(scene.c2w[0][:3, 3])))
    c2ws = np.stack([np.concatenate([m, [[0, 0, 0, 1.0]]], 0) for m in orbit]).astype(np.float32)
    c2ws_cv = conventions.blender2opencv(torch.from_numpy(c2ws)).numpy()
    tt.evaluation_path(trainer, c2ws_cv, scene.H, scene.W, scene.focal,
                       os.path.join(out_dir, "imgs_path_all"))
    log.info(f"render_path -> {out_dir}/imgs_path_all")


def export_mesh(a: dict, trainer, aabb, out_dir: str, res: int = 128) -> str:
    """The alpha of the density on a (res+1)^3 lattice over the bbox's x
    range, its 0.005 isosurface as <expname>.ply."""
    from ..evaluation.mesh import convert_density_samples_to_ply, query_density_grid

    def density_fn(pts):
        return tfm.compute_alpha(trainer.model_cfg, trainer.params, trainer.buffers, pts,
                                 trainer.geom.step_size)

    grid = query_density_grid(density_fn, res, (float(aabb[0][0]), float(aabb[1][0])),
                              device=trainer.device)
    path = os.path.join(out_dir, f"{a.get('expname', 'mesh')}.ply")
    n_v, n_f = convert_density_samples_to_ply(grid, path, aabb, level=0.005)
    log.info(f"mesh exported: {n_v} vertices, {n_f} faces -> {path}")
    return path


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--render_only", type=int, default=0)
    parser.add_argument("--render_path", type=int, default=0)
    parser.add_argument("--export_mesh", type=int, default=0)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--resume", type=int, default=0,
                        help="resume training from --ckpt / the default ckpt "
                             "(both Adams and global_step restored)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--textured", action="store_true",
                        help="the synthetic scene's textured field")
    parser.add_argument("--n_iters", type=int, default=0)
    parser.add_argument("--log_every", type=int, default=500)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device}: torch.cuda.is_available() is false; "
                         "pass --device cpu to run on the CPU")
    a = parse_txt_config(args.config)
    if args.synthetic:
        a["synthetic"] = True
    if args.n_iters:
        a["n_iters"] = args.n_iters
    model_cfg, train_cfg = build_configs(a)
    expname = a.get("expname", "tensorf")
    out_dir = os.path.join(a.get("basedir", "./log"), expname)
    os.makedirs(out_dir, exist_ok=True)
    writer = MetricWriter(out_dir)

    rays, rgbs, aabb, train_hw = load_rays(a, device, args.textured)
    model_name = a.get("model_name", "TensorVMSplit")
    trainer = build_family_trainer(a, model_cfg, train_cfg, aabb,
                                   torch.Generator(device=device).manual_seed(0), device)
    ckpt = args.ckpt or os.path.join(out_dir, f"{expname}.ckpt")

    if args.render_only:
        restore_tensorf_ckpt(ckpt, trainer)
        if a.get("synthetic"):
            scene = synthetic_scene(a, args.textured)
            psnrs, ssims = tt.evaluation(trainer, scene.poses.to(device), scene.intr.to(device),
                                         scene.images, os.path.join(out_dir, "imgs_test_all"),
                                         chunk=scene.H * scene.W)
            log.info(f"render_test: mean psnr {np.mean(psnrs):.2f} ssim {np.mean(ssims):.4f}")
        else:
            render_test_split(a, trainer, out_dir, fallback_hw=train_hw)
        if args.render_path:
            render_novel_path(a, trainer, out_dir, fallback_hw=train_hw)
        return out_dir
    if args.export_mesh:
        restore_tensorf_ckpt(ckpt, trainer)
        export_mesh(a, trainer, aabb, out_dir)
        return out_dir

    if args.resume and os.path.exists(ckpt):
        restore_tensorf_ckpt(ckpt, trainer, for_training=True)
        log.info(f"resumed training @ step {trainer.global_step}")
    remaining = max(0, train_cfg.n_iters - trainer.global_step)
    log.title(f"training {model_name} on {device}: {remaining} steps -> {out_dir}")
    m = trainer.train(rays, rgbs, n_iters=remaining,
                      generator=torch.Generator(device=device).manual_seed(1),
                      log_every=args.log_every)
    save_tensorf_ckpt(ckpt, trainer, model_name)
    if m:
        writer.scalar("train/psnr", float(m["psnr"]), trainer.global_step)
        log.info(f"final psnr {float(m['psnr']):.2f} -> {ckpt}")
    return out_dir


if __name__ == "__main__":
    main()
