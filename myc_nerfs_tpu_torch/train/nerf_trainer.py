"""Training for the MLP family: NeRF, BARF, GARF (counterpart of
myc_nerfs_tpu/train/nerf_trainer.py; barf model/base.py:15-167,
nerf.py:46-69, barf.py:59-88, garf.py:72-94).

- Each step draws R = rand_rays // n_images pixel indices and renders them
  in every training image (nerf.py:219: the same indices in every image).
- Two Adam optimizers with optax's semantics (the learning rate read at
  the count before the increment): the MLP's and the per-image se(3) pose
  corrections', each under an exponential decay from lr to lr_end over
  max_iter, the pose rate with an optional linear warmup.
- BARF's coarse-to-fine PE mask is driven by progress = step / max_iter
  (f32); GARF's delayed pose correction is a ``torch.where`` on the step.
- The random draws of a step are an argument (``StepDraws``: the ray
  indices, the stratified depth jitter, the density noise); ``draw_step``
  makes them from a torch.Generator. The JAX package scans a block of
  steps in one program (a TPU dispatch workaround); here a block is a
  Python loop (``train_block``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..geom import lie
from ..geom import pose as pose_lib
from ..geom import rays as rays_lib
from ..models.nerf_mlp import CoarseFine, NeRFMLP, garf_mlp
from ..render.mlp_renderer import render_image_mlp, render_rays_mlp
from ..utils import profiling
from ..utils.metrics import img2mse, mse2psnr
from .ngp_trainer import AdamState, _weak, adam_step, init_adam

# optax.adam's defaults
BETAS, EPS = (0.9, 0.999), 1e-8


@dataclasses.dataclass(frozen=True)
class NeRFTrainConfig:
    """The JAX NeRFTrainConfig's fields and defaults (barf options/*.yaml),
    without ``mlp_tile`` (a TPU layout workaround)."""

    model: str = "nerf"                    # nerf | barf | garf
    widths_feat: Tuple[int, ...] = (256,) * 8
    widths_rgb: Tuple[int, ...] = (128, 3)
    skip: Tuple[int, ...] = (4,)
    posenc_L3D: Optional[int] = 10
    posenc_Lview: Optional[int] = 4
    density_activ: str = "softplus"
    view_dep: bool = True
    depth_range: Tuple[float, float] = (2.0, 6.0)
    sample_intvs: int = 128
    sample_stratified: bool = True
    fine_sampling: bool = False
    sample_intvs_fine: int = 0
    rand_rays: int = 2048
    density_noise_reg: float = 0.0
    setbg_opaque: bool = False
    bgcolor: float = 1.0
    refine_pose: bool = False
    c2f: Optional[Tuple[float, float]] = None       # barf_blender: [0.1, 0.5]
    camera_noise: float = 0.0                        # synthetic pose perturbation
    start_pose_correct_iter: int = 0                 # garf (Easyship.yaml: 80000)
    lr: float = 5e-4
    lr_end: float = 1e-4
    lr_pose: float = 3e-3
    lr_pose_end: float = 1e-5
    warmup_pose: int = 0
    max_iter: int = 200000
    use_bf16: bool = False                           # bf16 products in the MLP


class NeRFTrainState(NamedTuple):
    params: nn.Module               # NeRFMLP, or CoarseFine with fine_sampling
    se3_refine: torch.Tensor        # [n_images, 6] pose corrections
    opt_state: AdamState
    opt_state_pose: AdamState
    pose_noise: torch.Tensor        # [n_images, 6] fixed synthetic noise
    step: torch.Tensor              # int32 scalar


class StepDraws(NamedTuple):
    """The random draws of one step: ``ray_idx`` [R] pixel indices (the same
    in every image), ``depth`` [B, R, N, 1] stratified jitter in [0, 1) (None
    without stratified sampling), ``noise`` [B, R, N] and ``noise_fine``
    [B, R, N + N_fine] standard normals of the density noise (None without
    it; the fine network's draw only with fine sampling)."""

    ray_idx: torch.Tensor
    depth: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None


def build_model(cfg: NeRFTrainConfig, device=None,
                generator: Optional[torch.Generator] = None) -> NeRFMLP:
    if cfg.model == "garf":
        return garf_mlp(widths_feat=cfg.widths_feat, widths_rgb=cfg.widths_rgb,
                        skip=cfg.skip, view_dep=cfg.view_dep, use_bf16=cfg.use_bf16,
                        device=device, generator=generator)
    return NeRFMLP(widths_feat=cfg.widths_feat, widths_rgb=cfg.widths_rgb, skip=cfg.skip,
                   posenc_L3D=cfg.posenc_L3D, posenc_Lview=cfg.posenc_Lview,
                   view_dep=cfg.view_dep, density_activ=cfg.density_activ,
                   use_bf16=cfg.use_bf16, device=device, generator=generator)


def exp_schedule(lr: float, lr_end: float, max_iter: int):
    """optax.exponential_decay(lr, 1, (lr_end / lr)^(1 / max_iter)):
    count -> lr * gamma^count in f32 (lr at count <= 0)."""
    gamma = (lr_end / lr) ** (1.0 / max_iter)

    def sched(count: torch.Tensor) -> torch.Tensor:
        # f32 on the count's device, with no host copy (a copy would sync)
        decayed = _weak(lr, torch.float32) * torch.pow(gamma, count.float())
        return torch.where(count <= 0, _weak(lr, torch.float32), decayed)
    return sched


def linear_warmup(steps: int):
    """optax.linear_schedule(0, 1, steps): count -> min(count, steps) / steps,
    computed as optax does, -(1 - c / steps) + 1, in f32."""
    def sched(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - torch.clamp(count, 0, steps).float() / steps
        return -1.0 * frac + 1.0
    return sched


def make_schedules(cfg: NeRFTrainConfig):
    """(the MLP's learning-rate schedule, the pose corrections') (nerf.py:31-44,
    barf.py:59-70; the reference's AdamW has weight decay 0)."""
    sched = exp_schedule(cfg.lr, cfg.lr_end, cfg.max_iter)
    sched_pose = exp_schedule(cfg.lr_pose, cfg.lr_pose_end, cfg.max_iter)
    if cfg.warmup_pose:
        base, warm = sched_pose, linear_warmup(cfg.warmup_pose)
        sched_pose = lambda count: base(count) * warm(count)  # noqa: E731
    return sched, sched_pose


def compose_refined_pose(cfg: NeRFTrainConfig, state: NeRFTrainState,
                         poses_gt: torch.Tensor) -> torch.Tensor:
    """se3_to_SE3(refine) o (se3_to_SE3(noise) o pose_gt), the correction
    applied only from step start_pose_correct_iter (barf.py get_pose,
    garf.py:318-346)."""
    poses = poses_gt
    if cfg.camera_noise:
        poses = pose_lib.compose_pair(lie.se3_to_SE3(state.pose_noise), poses)
    if not cfg.refine_pose:
        return poses
    refined = pose_lib.compose_pair(lie.se3_to_SE3(state.se3_refine), poses)
    gate = state.step >= cfg.start_pose_correct_iter
    # a device scalar: kept while a profiler records, no sync
    profiling.count("nerf.pose_refined", gate)
    return torch.where(gate, refined, poses)


def init_state(cfg: NeRFTrainConfig, generator: torch.Generator, n_images: int,
               device=None) -> NeRFTrainState:
    """Fresh weights from ``generator`` (the coarse network, the fine one
    with fine_sampling, then the pose noise, drawn once), zero corrections,
    zero Adam states, step 0; on ``device``."""
    params: nn.Module = build_model(cfg, device, generator)
    if cfg.fine_sampling:
        params = CoarseFine(params, build_model(cfg, device, generator))
    zeros = torch.zeros((n_images, 6), device=device)
    pose_noise = (cfg.camera_noise * torch.randn((n_images, 6), device=device,
                                                 generator=generator)
                  if cfg.camera_noise else zeros.clone())
    return NeRFTrainState(params=params, se3_refine=zeros, opt_state=init_adam(params.param_list()),
                          opt_state_pose=init_adam([zeros]), pose_noise=pose_noise,
                          step=torch.zeros((), dtype=torch.int32, device=device))


def draw_step(cfg: NeRFTrainConfig, n_images: int, H: int, W: int,
              generator: torch.Generator, device=None) -> StepDraws:
    """One step's draws from ``generator`` (ray indices, then jitter, then
    noise)."""
    R = max(cfg.rand_rays // n_images, 1)
    kw = dict(device=device, generator=generator)
    ray_idx = torch.randint(0, H * W, (R,), **kw)
    depth = (torch.rand((n_images, R, cfg.sample_intvs, 1), **kw)
             if cfg.sample_stratified else None)
    noise = noise_fine = None
    if cfg.density_noise_reg:
        noise = torch.randn((n_images, R, cfg.sample_intvs), **kw)
        if cfg.fine_sampling:
            noise_fine = torch.randn((n_images, R, cfg.sample_intvs + cfg.sample_intvs_fine),
                                     **kw)
    return StepDraws(ray_idx=ray_idx, depth=depth, noise=noise, noise_fine=noise_fine)


def make_loss(cfg: NeRFTrainConfig, images: torch.Tensor, poses_gt: torch.Tensor,
              intr: torch.Tensor):
    """The photometric loss over the dataset: images [B, H, W, 3], poses_gt
    [B, 3, 4], intr [B, 3, 3]. Returns loss_fn(state, draws) -> (loss,
    PSNR), differentiable in the state's params and se3_refine; with fine
    sampling the coarse loss plus the fine loss, and the fine PSNR."""
    B, H, W, _ = images.shape
    pixels = images.reshape(B, H * W, 3)
    grid = rays_lib.pixel_grid(H, W, dtype=poses_gt.dtype, device=images.device)
    bg = (torch.full((3,), cfg.bgcolor, dtype=images.dtype, device=images.device)
          if cfg.setbg_opaque else None)

    def make_apply(net, progress, noise):
        def apply_fn(points, ray_unit):
            return net(points, ray_unit, progress=progress, c2f=cfg.c2f,
                       density_noise=cfg.density_noise_reg, noise=noise)
        return apply_fn

    def loss_fn(state: NeRFTrainState, draws: StepDraws):
        with profiling.span("nerf.pose"):
            poses = compose_refined_pose(cfg, state, poses_gt)
            center, ray = rays_lib.get_center_and_ray(poses, intr, H, W,
                                                      xy_grid=grid[draws.ray_idx])
        progress = state.step.float() / cfg.max_iter
        target = pixels[:, draws.ray_idx]
        render = dict(rand=draws.depth, n_samples=cfg.sample_intvs,
                      depth_range=cfg.depth_range, bg_color=bg, view_dep=cfg.view_dep)
        if cfg.fine_sampling:
            # coarse loss + fine loss (loss_weight.render_fine, nerf.py:228-240)
            nets = state.params
            coarse = make_apply(nets.coarse, progress, draws.noise)
            out_c = render_rays_mlp(coarse, center, ray, **render)
            out_f = render_rays_mlp(coarse, center, ray, **render,
                                    fine_apply_fn=make_apply(nets.fine, progress,
                                                             draws.noise_fine),
                                    n_samples_fine=cfg.sample_intvs_fine)
            loss = img2mse(out_c.rgb, target) + img2mse(out_f.rgb, target)
            return loss, mse2psnr(img2mse(out_f.rgb, target))
        out = render_rays_mlp(make_apply(state.params, progress, draws.noise),
                              center, ray, **render)
        loss = img2mse(out.rgb, target)
        return loss, mse2psnr(loss)

    return loss_fn


def make_train_step(cfg: NeRFTrainConfig, images: torch.Tensor, poses_gt: torch.Tensor,
                    intr: torch.Tensor, reduce_grads=None):
    """The train step over the dataset (as make_loss), on the state's
    device. Returns step(state, draws: StepDraws) -> (new state, {"loss",
    "psnr"} as device scalars). The parameters are updated in place (the
    new state holds the same module).

    ``reduce_grads(grads) -> grads`` runs between the gradient and the two
    Adams on the MLP's gradients followed, with pose refinement, by
    se3_refine's (parallel/spmd.nerf_gradient_reduce: image-axis DP)."""
    loss_fn = make_loss(cfg, images, poses_gt, intr)
    sched, sched_pose = make_schedules(cfg)

    def step(state: NeRFTrainState, draws: StepDraws
             ) -> Tuple[NeRFTrainState, Dict[str, torch.Tensor]]:
        with profiling.span("nerf.step"):
            params = state.params.param_list()
            se3 = state.se3_refine.detach().requires_grad_(cfg.refine_pose)
            with torch.enable_grad():
                loss, psnr = loss_fn(state._replace(se3_refine=se3), draws)
                wrt = params + ([se3] if cfg.refine_pose else [])
                with profiling.span("nerf.backward"):
                    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, grads)]
            if reduce_grads is not None:
                grads = reduce_grads(grads)
            with torch.no_grad(), profiling.span("nerf.update"):
                updates, opt_state = adam_step(sched, BETAS, EPS, grads[:len(params)],
                                               state.opt_state)
                torch._foreach_add_(params, updates)
                se3_refine, opt_state_pose = state.se3_refine, state.opt_state_pose
                if cfg.refine_pose:
                    up_pose, opt_state_pose = adam_step(sched_pose, BETAS, EPS, grads[-1:],
                                                        state.opt_state_pose)
                    se3_refine = state.se3_refine + up_pose[0]
            new_state = state._replace(se3_refine=se3_refine, opt_state=opt_state,
                                       opt_state_pose=opt_state_pose, step=state.step + 1)
            return new_state, {"loss": loss.detach(), "psnr": psnr.detach()}

    return step


def train_block(step, state: NeRFTrainState, draws: Sequence[StepDraws]
                ) -> Tuple[NeRFTrainState, Dict[str, torch.Tensor]]:
    """len(draws) steps one after another; the last step's metrics."""
    metrics: Dict[str, torch.Tensor] = {}
    for d in draws:
        state, metrics = step(state, d)
    return state, metrics


@torch.no_grad()
def render_validation(cfg: NeRFTrainConfig, params: nn.Module, pose: torch.Tensor,
                      intr: torch.Tensor, H: int, W: int, chunk: int = 2048
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A whole image at the bin midpoints, progress 1 (validate(),
    base.py:131-148) -> (rgb [H, W, 3], depth [H, W]). With fine sampling
    the eval path runs the coarse -> PDF -> fine graph of training."""
    bg = torch.full((3,), cfg.bgcolor, device=pose.device) if cfg.setbg_opaque else None
    progress = torch.ones((), dtype=torch.float32, device=pose.device)

    def apply_of(net):
        return lambda points, ray_unit: net(points, ray_unit, progress=progress, c2f=cfg.c2f)

    fine_apply, n_fine = None, 0
    if isinstance(params, CoarseFine):
        fine_apply, n_fine = apply_of(params.fine), cfg.sample_intvs_fine
        params = params.coarse
    return render_image_mlp(apply_of(params), pose, intr, H, W, cfg.sample_intvs,
                            cfg.depth_range, bg_color=bg, view_dep=cfg.view_dep,
                            chunk=chunk, fine_apply_fn=fine_apply, n_samples_fine=n_fine)
