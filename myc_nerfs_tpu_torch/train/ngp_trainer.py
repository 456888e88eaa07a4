"""NGP trainer, render half (counterpart of myc_nerfs_tpu/train/ngp_trainer.py).

Holds the model, the occupancy grid and the step counter (jnerf
Runner, runner.py:16-85), keeps the grid fresh (``grid_update``) and
renders whole images in 4096-ray chunks (Runner.render_img). The training
step, Adam/EMA and the batch adaptation are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..models.ngp import NGPModel, NGPModelConfig
from ..render import occupancy as occ
from ..render.ngp_render import NGPRenderConfig, render_rays_ngp


def huber_loss(x: torch.Tensor, y: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    """Elementwise Huber (jnerf losses/huber_loss.py:6-13)."""
    d = torch.abs(x - y)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


@dataclasses.dataclass(frozen=True)
class NGPTrainConfig:
    """Same fields and defaults as the JAX NGPTrainConfig (projects/ngp
    configs). The optimizer fields are carried for the training port."""

    lr: float = 1e-1
    eps: float = 1e-15
    betas: Tuple[float, float] = (0.9, 0.99)
    ema_decay: float = 0.95
    decay_start: int = 20000
    decay_interval: int = 10000
    decay_base: float = 0.33
    n_rays_per_batch: int = 4096
    target_batch_size: int = 1 << 18
    update_den_freq: int = 16
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    huber_delta: float = 0.1
    tot_train_steps: int = 40000
    n_grid_uniform: int = 1 << 16
    n_grid_nonuniform: int = 1 << 16
    skip_nonfinite: bool = False
    fp16_grads: bool = False
    fp16_grad_scale: float = 128.0
    clip_grad_norm: float = 0.0
    warmup_steps: int = 0
    n_compact_schedule: Optional[Tuple[Tuple[int, int], ...]] = None


class NGPTrainState(NamedTuple):
    params: NGPModel
    occ: occ.OccupancyState
    step: int


class NGPTrainer:
    """Host-side orchestration. ``device`` places every tensor; the
    generator draws the initial weights."""

    def __init__(self, model_cfg: NGPModelConfig, rcfg: NGPRenderConfig,
                 cfg: NGPTrainConfig, generator: torch.Generator, device=None,
                 camera_c2w: Optional[torch.Tensor] = None,
                 focal: Optional[torch.Tensor] = None,
                 image_wh: Optional[Tuple[int, int]] = None,
                 loss_fn=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.rcfg = rcfg
        self.cfg = cfg
        self.loss_fn = loss_fn or (lambda x, y: huber_loss(x, y, cfg.huber_delta))
        max_cascade = 0
        while (1 << max_cascade) < rcfg.aabb_scale:
            max_cascade += 1
        self.occ_cfg = occ.OccupancyConfig(max_cascade=max_cascade)
        max_aabb_scale = 1 << (self.occ_cfg.n_cascades - 1)
        if rcfg.aabb_scale > max_aabb_scale:
            raise ValueError(
                f"aabb_scale={rcfg.aabb_scale} exceeds the supported "
                f"{max_aabb_scale} (grid has {self.occ_cfg.n_cascades} "
                "cascades; raise OccupancyConfig.n_cascades by factors of 2)")
        self.model = NGPModel(model_cfg, device=self.device, generator=generator)
        occ_state = occ.init_occupancy(self.occ_cfg, self.device)
        if camera_c2w is not None:
            grid0 = occ.mark_untrained(self.occ_cfg, camera_c2w.to(self.device),
                                       focal.to(self.device), image_wh[0],
                                       image_wh[1])
            occ_state = occ_state._replace(density_grid=grid0)
        self.state = NGPTrainState(params=self.model, occ=occ_state, step=0)
        self.grid_update = occ.make_density_grid_update(
            self.occ_cfg, self.model.density_raw, cfg.n_grid_uniform,
            cfg.n_grid_nonuniform, aabb=rcfg.aabb)
        # host-side step for schedule decisions; a restore must call
        # set_host_step()
        self.host_step = 0
        self._apply_march_schedule()

    def set_host_step(self, step: int) -> None:
        """Sync the host step after a checkpoint restore and apply the
        march-schedule stage that step falls into."""
        self.host_step = int(step)
        self._apply_march_schedule()

    def _apply_march_schedule(self) -> None:
        """Set rcfg.n_compact from cfg.n_compact_schedule at host_step."""
        sched = self.cfg.n_compact_schedule
        if not sched:
            return
        nc = None
        for frm, v in sched:
            if self.host_step >= frm:
                nc = v
        if nc is not None and nc != self.rcfg.n_compact:
            self.rcfg = dataclasses.replace(self.rcfg, n_compact=nc)

    @torch.no_grad()
    def render_image(self, pose_c2w: torch.Tensor, intr: torch.Tensor,
                     H: int, W: int, chunk: int = 4096
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunked full-image render (Runner.render_img, runner.py:195-228).
        Returns (rgb [H, W, 3], depth [H, W])."""
        from ..geom import rays as rays_lib

        pose_c2w = torch.as_tensor(pose_c2w, dtype=torch.float32, device=self.device)
        intr = torch.as_tensor(intr, dtype=torch.float32, device=self.device)
        d = rays_lib.get_ray_directions(H, W, (intr[0, 0], intr[1, 1]),
                                        center=(intr[0, 2], intr[1, 2]),
                                        device=self.device)
        rays_d = d.reshape(-1, 3) @ pose_c2w[:3, :3].T
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o = pose_c2w[:3, 3].expand(rays_d.shape)
        n = H * W
        pad = (-n) % chunk
        rays_o = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
        rays_d = torch.nn.functional.pad(rays_d, (0, 0, 0, pad))
        bg = torch.tensor(self.cfg.background_color, dtype=torch.float32,
                          device=self.device)
        rgbs, depths = [], []
        for s in range(0, n + pad, chunk):
            out = render_rays_ngp(self.occ_cfg, self.rcfg, self.model,
                                  self.state.occ, rays_o[s:s + chunk],
                                  rays_d[s:s + chunk], bg)
            rgbs.append(out.rgb)
            depths.append(out.depth)
        rgb = torch.cat(rgbs)[:n].reshape(H, W, 3)
        depth = torch.cat(depths)[:n].reshape(H, W)
        return rgb, depth
