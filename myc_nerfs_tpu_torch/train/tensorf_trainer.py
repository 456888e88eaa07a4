"""Staged TensoRF training (counterpart of myc_nerfs_tpu/train/tensorf_trainer.py;
tensorf-myc train.py reconstruction()).

- ray-level SGD over a precomputed ray store, batches from a random
  permutation (SimpleSampler, train.py:25-37); the permutation is copied
  to the device once per epoch, so a step's ray ids never cross the bus;
- loss = MSE + ortho + L1 (its weight switches at the first alpha-mask
  step) + TV, the TV weights decayed by lr_factor^(step + 1) on the global
  step (train.py:228-257), + Ref-TensoRF's extra loss;
- two Adams (b1 0.9, b2 0.99, eps 1e-8) with optax's semantics: the
  factor grids ("spatial", lr_init) and the basis matrix and modules
  ("net", lr_basis), each at base * lr_scale * lr_factor^count, the count
  read before its increment (tensoRF.py:168-174, train.py:176-183,270-271);
- events as the reference's: the alpha-mask update (with the fallback for
  a degenerate mask), the shrink at the first alpha-mask step, the ray
  refilter at the second, the upsample along the log-space voxel schedule
  (train.py:293-330). Every event re-creates both Adams: the moments and
  counts restart, the learning-rate decay from lr_scale; the TV decay does
  not restart.

The JAX package scans blocks of steps in one program (a TPU dispatch
workaround); here a step is a Python call. A step's draws are an argument
(``draws``) or come from a torch.Generator; a step syncs with the host only
for the two ``nonzero`` of the boolean sample selection.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geom import rays as rays_lib
from ..models import tensorf as tf
from ..evaluation.visualization import save_image
from ..utils.metrics import mse2psnr
from .ngp_trainer import adam_step, init_adam

BETAS, EPS = (0.9, 0.99), 1e-8


@dataclasses.dataclass(frozen=True)
class TensoRFTrainConfig:
    """The JAX TensoRFTrainConfig's fields and defaults (tensorf opt.py)."""

    n_iters: int = 30000
    batch_size: int = 4096
    lr_init: float = 0.02
    lr_basis: float = 1e-3
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    lr_upsample_reset: bool = True
    ortho_weight: float = 0.0
    l1_weight_initial: float = 0.0
    l1_weight_rest: float = 0.0
    tv_weight_density: float = 0.0
    tv_weight_app: float = 0.0
    n_voxel_init: int = 100**3
    n_voxel_final: int = 300**3
    upsamp_list: Tuple[int, ...] = (2000, 3000, 4000, 5500, 7000)
    update_alphamask_list: Tuple[int, ...] = (2000, 4000)
    alpha_mask_reso_cap: int = 256
    n_samples_cap: int = 1_000_000
    white_bg: bool = True


def n_to_reso(n_voxels: int, aabb) -> List[int]:
    """Voxel count -> per-axis resolution (tensorf utils.py:56-59)."""
    aabb = np.asarray(aabb, np.float64)
    size = aabb[1] - aabb[0]
    voxel_size = (size.prod() / n_voxels) ** (1.0 / 3)
    return [int(x) for x in (size / voxel_size)]


def n_voxel_schedule(cfg: TensoRFTrainConfig) -> List[int]:
    """Log-space N_voxel schedule (train.py:196-197)."""
    n = len(cfg.upsamp_list) + 1
    return [int(round(v)) for v in np.exp(np.linspace(
        np.log(cfg.n_voxel_init), np.log(cfg.n_voxel_final), n))][1:]


def lr_factor_of(cfg: TensoRFTrainConfig) -> float:
    return cfg.lr_decay_target_ratio ** (
        1.0 / (cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters))


def decay_schedule(init: float, factor: float):
    """optax.exponential_decay(init, 1, factor): count -> init * factor^count
    in f32 (init at count <= 0), on the count's device."""
    init32 = float(np.float32(init))

    def sched(count: torch.Tensor) -> torch.Tensor:
        decayed = init32 * torch.pow(factor, count.float())
        return torch.where(count <= 0, init32, decayed)
    return sched


def tensorf_loss(model_cfg: tf.TensoRFConfig, cfg: TensoRFTrainConfig, forward_fn,
                 extra_loss_fn, lr_factor: float, params, rays, rgbs, draws,
                 step: torch.Tensor):
    """(total loss, mse, forward output) of one batch at global ``step``
    (an int32 scalar tensor) (_make_step_core's loss_fn)."""
    out = forward_fn(params, rays, draws)
    mse = torch.mean((out.rgb_map - rgbs) ** 2)
    total = mse
    if cfg.ortho_weight > 0:
        total = total + cfg.ortho_weight * tf.vector_comp_diffs(params)
    first = cfg.update_alphamask_list[0] if cfg.update_alphamask_list else cfg.n_iters
    l1_w = torch.where(step < first, cfg.l1_weight_initial, cfg.l1_weight_rest)
    total = total + l1_w * tf.density_L1(model_cfg, params)
    decay = torch.pow(lr_factor, step.float() + 1.0)
    if cfg.tv_weight_density > 0:
        total = total + cfg.tv_weight_density * decay * tf.tv_loss_density(model_cfg, params)
    if cfg.tv_weight_app > 0:
        total = total + cfg.tv_weight_app * decay * tf.tv_loss_app(model_cfg, params)
    if extra_loss_fn is not None:
        total = total + extra_loss_fn(params, out)
    return total, mse, out


class PermutationSampler:
    """Random-permutation ray batches (SimpleSampler, train.py:25-37)."""

    def __init__(self, total: int, batch: int, seed: int = 0):
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self.rng = np.random.default_rng(seed)

    def nextids(self) -> np.ndarray:
        self.curr += self.batch
        if self.ids is None or self.curr + self.batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr:self.curr + self.batch]


def base_draws(trainer, n_rays: int, generator: torch.Generator) -> torch.Tensor:
    """sample_ray's jitter [N, 1]."""
    return torch.rand((n_rays, 1), generator=generator, device=trainer.device)


class TensoRFTrainer:
    """Owns params, buffers, the stage geometry and both Adams across stages.

    ``forward_fn(model_cfg, geom, params, buffers, rays, draws, white_bg)``
    swaps the model (Ref-TensoRF, NeRF++; default tensorf_forward),
    ``draw_fn(trainer, n_rays, generator)`` makes its draws, and
    ``extra_loss_fn(params, out)`` adds to the loss."""

    def __init__(self, model_cfg: tf.TensoRFConfig, cfg: TensoRFTrainConfig, aabb,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 extra_loss_fn=None, forward_fn=None, draw_fn=None):
        self.model_cfg, self.cfg = model_cfg, cfg
        self.device = torch.device(device)
        self.extra_loss_fn = extra_loss_fn
        self.forward_fn = forward_fn or (
            lambda mc, g, p, b, r, d, white_bg: tf.tensorf_forward(mc, g, p, b, r, d,
                                                                   white_bg=white_bg))
        self.draw_fn = draw_fn or base_draws
        reso = n_to_reso(cfg.n_voxel_init, np.asarray(aabb))
        self.geom = tf.compute_stage_geom(model_cfg, np.asarray(aabb), reso, cfg.n_samples_cap)
        self.params, self.buffers = tf.init_tensorf(model_cfg, aabb, reso, generator,
                                                    self.device)
        self.voxel_schedule = n_voxel_schedule(cfg)
        self.lr_factor = lr_factor_of(cfg)
        self.set_step(0)
        self._rebuild(lr_scale=1.0)

    def set_step(self, global_step: int) -> None:
        """The global step, on the host and as the device's int32 counter."""
        self.global_step = int(global_step)
        self.step_t = torch.tensor(self.global_step, dtype=torch.int32, device=self.device)

    def _rebuild(self, lr_scale: float) -> None:
        """Fresh Adams (zero moments, counts 0) at ``lr_scale``."""
        self.lr_scale = lr_scale
        spatial, net = tf.group_leaves(self.params)
        self.opt_spatial, self.opt_net = init_adam(spatial), init_adam(net)
        self.sched_spatial = decay_schedule(self.cfg.lr_init * lr_scale, self.lr_factor)
        self.sched_net = decay_schedule(self.cfg.lr_basis * lr_scale, self.lr_factor)

    def forward(self, params, rays, draws, white_bg: Optional[bool] = None):
        wb = self.cfg.white_bg if white_bg is None else white_bg
        return self.forward_fn(self.model_cfg, self.geom, params, self.buffers, rays, draws, wb)

    def loss(self, rays, rgbs, draws, params=None, step=None):
        """(total, mse, out) of a batch at the current (or given) step."""
        return tensorf_loss(self.model_cfg, self.cfg,
                            lambda p, r, d: self.forward(p, r, d), self.extra_loss_fn,
                            self.lr_factor, self.params if params is None else params,
                            rays, rgbs, draws, self.step_t if step is None else step)

    def grads(self, rays, rgbs, draws):
        """(spatial grads, net grads, mse) of a batch."""
        spatial, net = tf.group_leaves(self.params)
        with torch.enable_grad():
            total, mse, _ = self.loss(rays, rgbs, draws)
            grads = torch.autograd.grad(total, spatial + net, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(spatial + net, grads)]
        return grads[:len(spatial)], grads[len(spatial):], mse.detach()

    def train_step(self, rays, rgbs, draws) -> Dict[str, torch.Tensor]:
        """One SGD step; params are updated in place. Returns {"mse", "psnr"}
        as device scalars."""
        g_s, g_n, mse = self.grads(rays, rgbs, draws)
        spatial, net = tf.group_leaves(self.params)
        with torch.no_grad():
            up, self.opt_spatial = adam_step(self.sched_spatial, BETAS, EPS, g_s,
                                             self.opt_spatial)
            torch._foreach_add_(spatial, up)
            up, self.opt_net = adam_step(self.sched_net, BETAS, EPS, g_n, self.opt_net)
            torch._foreach_add_(net, up)
            self.step_t += 1
        self.global_step += 1
        return {"mse": mse, "psnr": mse2psnr(mse)}

    def train(self, all_rays: torch.Tensor, all_rgbs: torch.Tensor,
              n_iters: Optional[int] = None, generator: Optional[torch.Generator] = None,
              log_every: int = 0, draws: Optional[Callable[[int], object]] = None):
        """Train n_iters (default cfg.n_iters) steps from global_step, with
        the events on their iterations. ``draws(it)`` gives step it's draws
        (default: draw_fn from ``generator``, seeded 0 when None). Returns
        the last step's metrics."""
        cfg = self.cfg
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        sampler = PermutationSampler(all_rays.shape[0], cfg.batch_size)
        perm_src, perm = None, None
        metrics: Dict[str, torch.Tensor] = {}
        end = self.global_step + (cfg.n_iters if n_iters is None else n_iters)
        while self.global_step < end:
            it = self.global_step
            n = len(sampler.nextids())
            if sampler.ids is not perm_src:
                perm_src = sampler.ids
                perm = torch.from_numpy(perm_src).to(self.device)
            ids = perm[sampler.curr:sampler.curr + n]
            d = draws(it) if draws is not None else self.draw_fn(self, n, gen)
            metrics = self.train_step(all_rays[ids], all_rgbs[ids], d)
            if log_every and it % log_every == 0:
                print(f"iter {it} psnr {float(metrics['psnr']):.2f}", flush=True)
            filtered = self.events(it + 1, all_rays)
            if filtered is not None:
                all_rays, all_rgbs = all_rays[filtered], all_rgbs[filtered]
                sampler = PermutationSampler(all_rays.shape[0], cfg.batch_size)
        return metrics

    def events(self, step: int, all_rays: torch.Tensor) -> Optional[torch.Tensor]:
        """The events after ``step`` steps; returns the mask of the rays to
        keep at the ray refilter, else None."""
        cfg = self.cfg
        keep = None
        if step in cfg.update_alphamask_list:
            reso_mask = [min(g, cfg.alpha_mask_reso_cap) for g in self.geom.grid_size]
            self.buffers, new_aabb = tf.update_alpha_mask(self.model_cfg, self.geom, self.params,
                                                          self.buffers, tuple(reso_mask))
            degenerate = (not np.all(np.isfinite(new_aabb))) or np.any(new_aabb[1] <= new_aabb[0])
            if degenerate:
                # an empty mask (nothing above the threshold yet): keep the
                # AABB and drop the mask
                new_aabb = self.buffers["aabb"].cpu().numpy()
                self.buffers["alpha_volume"] = None
                self.buffers = tf.prepare_alpha_buffers(self.buffers)
            if step == cfg.update_alphamask_list[0] and not degenerate:
                self.params, self.buffers, new_size = tf.shrink(
                    self.model_cfg, self.geom, self.params, self.buffers, new_aabb)
                self.geom = tf.compute_stage_geom(self.model_cfg,
                                                  self.buffers["aabb"].cpu().numpy(),
                                                  new_size, cfg.n_samples_cap)
            if len(cfg.update_alphamask_list) > 1 and step == cfg.update_alphamask_list[1]:
                keep = tf.filter_rays_bbox(self.buffers["aabb"], all_rays)
            self._rebuild(lr_scale=1.0)
        if step in cfg.upsamp_list:
            n_vox = self.voxel_schedule.pop(0)
            aabb = self.buffers["aabb"].cpu().numpy()
            reso = n_to_reso(n_vox, aabb)
            self.params = tf.upsample_volume_grid(self.model_cfg, self.params, reso)
            self.geom = tf.compute_stage_geom(self.model_cfg, aabb, reso, cfg.n_samples_cap)
            lr_scale = (1.0 if cfg.lr_upsample_reset
                        else cfg.lr_decay_target_ratio ** ((step - 1) / cfg.n_iters))
            self._rebuild(lr_scale=lr_scale)
        return keep

    @torch.no_grad()
    def render_rays(self, rays: torch.Tensor, chunk: int = 4096):
        """Chunked eval render at the unjittered samples
        (OctreeRender_trilinear_fast, renderer.py:12-27) -> (rgb [N, 3],
        depth [N])."""
        rgbs, depths = [], []
        for a in range(0, rays.shape[0], chunk):
            out = self.forward(self.params, rays[a:a + chunk], None)
            rgbs.append(out.rgb_map)
            depths.append(out.depth_map)
        return torch.cat(rgbs), torch.cat(depths)


def build_ray_store(poses: torch.Tensor, intr: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Every (origin, unit direction) ray of every image, [N*H*W, 6], as
    tensorf's blender loader (dataLoader/blender.py:116-128)."""
    center, ray = rays_lib.get_center_and_ray(poses, intr, H, W)
    d = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    return torch.cat([center, d], dim=-1).reshape(-1, 6)


def evaluation(trainer: TensoRFTrainer, poses, intr, images, out_dir: str, prefix: str = "",
               chunk: int = 4096, compute_extra_metrics: bool = True,
               H: Optional[int] = None, W: Optional[int] = None, ray_fn=None):
    """Whole-image eval (tensorf renderer.py:30-148): rgb and depth images
    (.npy, and .png with PIL), PSNR and SSIM against ``images`` (None or
    empty: GT-less, H and W required) and mean.txt. ``ray_fn(i) -> [H*W, 6]``
    replaces the default rays of poses[i] / intr[i]. Returns (psnrs, ssims)."""
    from ..evaluation.visualization import visualize_depth
    from ..utils.metrics import psnr as psnr_fn, ssim as ssim_fn

    os.makedirs(out_dir, exist_ok=True)
    have_gt = images is not None and len(images) > 0
    if have_gt:
        H, W = images.shape[1:3]
    if H is None or W is None:
        raise ValueError("H and W are required without GT images")
    psnrs, ssims = [], []
    for i in range(poses.shape[0]):
        rays = (ray_fn(i) if ray_fn is not None
                else build_ray_store(poses[i:i + 1], intr[i:i + 1], H, W))
        rgb, depth = trainer.render_rays(rays.to(trainer.device), chunk=chunk)
        rgb = rgb.reshape(H, W, 3)
        if have_gt and i < len(images):
            gt = torch.as_tensor(images[i], device=rgb.device)
            psnrs.append(float(psnr_fn(rgb, gt)))
            if compute_extra_metrics:
                ssims.append(float(ssim_fn(rgb, gt)))
        save_image(os.path.join(out_dir, f"{prefix}{i:03d}"), rgb.cpu().numpy())
        dimg, _ = visualize_depth(depth.reshape(H, W).cpu().numpy())
        save_image(os.path.join(out_dir, f"{prefix}{i:03d}_depth"), dimg)
    if psnrs:
        with open(os.path.join(out_dir, "mean.txt"), "w") as f:
            f.write(f"psnr {float(np.mean(psnrs))}\n")
            if ssims:
                f.write(f"ssim {float(np.mean(ssims))}\n")
    return psnrs, ssims


def evaluation_path(trainer: TensoRFTrainer, c2ws, H: int, W: int, focal: float,
                    out_dir: str, chunk: int = 4096, fps: int = 30, ray_fn=None):
    """Novel-view render along a camera path (renderer.py:91-148): each
    c2w's frame (.npy / .png) and an rgb + depth video (write_video)."""
    from ..evaluation.visualization import visualize_depth, write_video

    os.makedirs(out_dir, exist_ok=True)
    dirs = rays_lib.get_ray_directions(H, W, focal, device=trainer.device)
    frames = []
    for i, c2w in enumerate(c2ws):
        if ray_fn is not None:
            rays = ray_fn(i)
        else:
            c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=trainer.device)
            o, d = rays_lib.get_rays_from_directions(dirs, c2w[:3])
            rays = torch.cat([o, d], -1)
        rgb, depth = trainer.render_rays(rays.to(trainer.device), chunk=chunk)
        rgb = torch.clamp(rgb, 0, 1).reshape(H, W, 3).cpu().numpy()
        dimg, _ = visualize_depth(depth.reshape(H, W).cpu().numpy())
        frames.append(np.concatenate([rgb, dimg], axis=1))
        save_image(os.path.join(out_dir, f"{i:03d}"), rgb)
    write_video(os.path.join(out_dir, "video.mp4"), frames, fps=fps)
    return out_dir
