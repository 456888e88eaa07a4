"""NGP trainer (counterpart of myc_nerfs_tpu/train/ngp_trainer.py).

jnerf Runner (runner.py:16-85) on the port:

- Adam(lr, eps 1e-15, betas (0.9, 0.99)) under the ExpDecay schedule with
  optax's semantics: the learning rate is read at the step count before
  the increment, and the moments are kept in each parameter's dtype;
- the GradScaler emulation of fp16 configs (``fp16_grads``,
  ``skip_nonfinite``), the optional global-norm clip, and the reference's
  EMA blended into the live parameters after every step (ema.py:26-42);
- Huber loss, per-step march jitter, occupancy-grid updates and the
  ray-batch adaptation toward ``target_batch_size`` samples
  (density_grid_sampler.py:251-267);
- whole-image chunked renders (Runner.render_img).

The JAX package scans a block of steps in one program (a TPU dispatch
workaround); here ``train_block`` is a Python loop over the steps. Each
step's march jitter ``xi`` [B, 1] is an argument (the JAX package draws it
as ``jax.random.uniform(key, (B, 1))``) or comes from a torch.Generator.

With a ``mesh`` (parallel/mesh.py) each rank trains on its shard of the
batch: the gradients are averaged over the mesh between ``backward`` and
``update`` (so the clip, the fp16 emulation, the non-finite skip and Adam
see the global gradient, as under GSPMD) and the step's metrics are the
global batch's. The occupancy-grid update needs no collective: every rank
draws the same samples from its equally seeded generator and evaluates the
same replicated model, so the grids stay equal (checked in the tests and
by chip_smoke's multichip phase).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.ngp import NGPModel, NGPModelConfig
from ..parallel import mesh as mesh_lib
from ..render import occupancy as occ
from ..render.ngp_render import NGPRenderConfig, render_rays_ngp
from ..utils.metrics import mse2psnr
from ..utils.profiling import span


def huber_loss(x: torch.Tensor, y: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    """Elementwise Huber (jnerf losses/huber_loss.py:6-13)."""
    d = torch.abs(x - y)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


_LADDER_MANTISSAS = (1.0, 1.25, 1.5, 1.75)


def _ladder_floor(rays: int) -> int:
    """Largest quarter-octave rung ({1, 1.25, 1.5, 1.75} x 2^k) <= rays
    (at least 128), as the JAX package snaps the adapted batch."""
    rays = max(128, int(rays))
    k = int(np.floor(np.log2(rays)))
    best = 1 << k
    for m in _LADDER_MANTISSAS:
        cand = int(m * (1 << k))
        if cand <= rays:
            best = max(best, cand)
    return best


@dataclasses.dataclass(frozen=True)
class NGPTrainConfig:
    """Same fields and defaults as the JAX NGPTrainConfig (projects/ngp
    configs)."""

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


class AdamState(NamedTuple):
    """optax.adam's state: one step count (optax keeps two, for the moments
    and for the schedule, and they always agree) and the moments, one per
    parameter in NGPModel.param_list() order, each in its parameter's
    dtype."""

    count: torch.Tensor        # int32 scalar, on the parameters' device
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class NGPTrainState(NamedTuple):
    params: torch.nn.Module  # the model (NGPModel, or the trainer's override)
    opt_state: AdamState
    occ: occ.OccupancyState
    step: int


@functools.lru_cache(maxsize=None)
def _weak(v: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``, as JAX rounds a weakly typed
    scalar before it meets an array of that dtype."""
    return torch.tensor(v, dtype=dtype).item()


def make_lr_schedule(cfg: NGPTrainConfig):
    """ExpDecay (expdecay.py:20-26): lr * base^n, n = number of boundaries
    start + k*interval at or below ``step``; with cfg.warmup_steps, times
    min(1, (step+1)/warmup). Returns sched(step int tensor) -> f32 tensor."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.int32)
        n = torch.clamp_min(torch.div(step - cfg.decay_start, cfg.decay_interval,
                                      rounding_mode="floor") + 1, 0)
        base = torch.tensor(cfg.decay_base, dtype=torch.float32, device=step.device)
        lr = cfg.lr * base ** n
        if cfg.warmup_steps > 0:
            lr = lr * torch.clamp_max((step + 1) / cfg.warmup_steps, 1.0)
        return lr
    return sched


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    device = params[0].device if params else None
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


def adam_update(cfg: NGPTrainConfig, grads: Sequence[torch.Tensor],
                state: AdamState) -> Tuple[List[torch.Tensor], AdamState]:
    """optax.adam(make_lr_schedule(cfg), b1, b2, eps) update: (updates to
    add to the params, new state)."""
    return adam_step(make_lr_schedule(cfg), cfg.betas, cfg.eps, grads, state)


def adam_step(schedule, betas: Tuple[float, float], eps: float,
              grads: Sequence[torch.Tensor], state: AdamState
              ) -> Tuple[List[torch.Tensor], AdamState]:
    """optax.adam(schedule, b1, b2, eps) update: (updates to add to the
    params, new state). The learning rate is ``schedule(count)`` at the
    count before the increment. Each operation rounds to its operands'
    dtype, as optax does in bf16."""
    b1, b2 = betas
    mu = [_weak(1 - b1, g.dtype) * g + _weak(b1, m.dtype) * m
          for g, m in zip(grads, state.mu)]
    nu = [_weak(1 - b2, g.dtype) * (g * g) + _weak(b2, v.dtype) * v
          for g, v in zip(grads, state.nu)]
    count = torch.where(state.count < torch.iinfo(torch.int32).max,
                        state.count + 1, state.count)
    # f32 powers of the count on its device (no host copy, no sync)
    c1 = 1 - torch.pow(b1, count)
    c2 = 1 - torch.pow(b2, count)
    step_size = -schedule(state.count)
    updates = []
    for m, v in zip(mu, nu):
        u = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + _weak(eps, v.dtype))
        updates.append(step_size.to(u.dtype) * u)
    return updates, AdamState(count=count, mu=mu, nu=nu)


def ema_step(cfg: NGPTrainConfig, params: Sequence[torch.Tensor],
             shadow: Sequence[torch.Tensor], step: int) -> List[torch.Tensor]:
    """The reference's EMA blended into the live params (ema.py:26-42):
    p <- ((1-d) p + d v (1 - d^(n-1))) / (1 - d^n), n = step + 1, in f32;
    ``shadow`` (v) is the previous step's final params. Returns the blend,
    each in its param's dtype."""
    d = cfg.ema_decay
    n = np.float32(step) + np.float32(1.0)
    d32 = np.float32(d)
    debias_old = float(np.float32(1.0) - d32 ** (n - np.float32(1.0)))
    debias_new = float(np.float32(1.0) / (np.float32(1.0) - d32 ** n))
    return [((_weak(1.0 - d, torch.float32) * p.float()
              + _weak(d, torch.float32) * v.float() * debias_old)
             * debias_new).to(p.dtype) for p, v in zip(params, shadow)]


def apply_param_update(cfg: NGPTrainConfig, params: Sequence[torch.Tensor],
                       opt_state: AdamState, step: int,
                       grads: Sequence[torch.Tensor]
                       ) -> Tuple[List[torch.Tensor], AdamState, Optional[torch.Tensor]]:
    """The shared tail of every train step, as the JAX package's: the
    optional clip, the fp16 gradient emulation (x scale -> float16 ->
    / scale), the Adam update with a cast that keeps each param's dtype,
    and the EMA blend. With cfg.skip_nonfinite a step whose gradients hold
    inf/nan leaves params and optimizer state as they were (the blend still
    runs). Returns (new params, new optimizer state, the all-finite flag or
    None without skip_nonfinite). The inputs are not modified."""
    grads = list(grads)
    if cfg.clip_grad_norm > 0:
        # optax.global_norm: each leaf's sum of squares in its own dtype
        gn = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp_max(cfg.clip_grad_norm / (gn + 1e-12), 1.0)
        # a bf16 gradient times an f32 scale is f32, as in JAX
        grads = [g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
                 for g in grads]
    if cfg.fp16_grads:
        s = cfg.fp16_grad_scale
        grads = [(g.float() * s).to(torch.float16).to(g.dtype) / _weak(s, g.dtype)
                 for g in grads]
    updates, new_opt = adam_update(cfg, grads, opt_state)
    new = [(p + u).to(p.dtype) for p, u in zip(params, updates)]
    finite = None
    if cfg.skip_nonfinite:
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        new = [torch.where(finite, a, b) for a, b in zip(new, params)]
        # the state keeps its dtypes, even where a clip promoted the new
        # moments to f32 (the JAX package's lax.cond raises there)
        new_opt = AdamState(
            count=torch.where(finite, new_opt.count, opt_state.count),
            mu=[torch.where(finite, a, b).to(b.dtype) for a, b in zip(new_opt.mu, opt_state.mu)],
            nu=[torch.where(finite, a, b).to(b.dtype) for a, b in zip(new_opt.nu, opt_state.nu)])
    return ema_step(cfg, new, params, step), new_opt, finite


class NGPTrainer:
    """Host-side orchestration. ``device`` (cuda unless the caller asks for
    the CPU) places every tensor; the generator draws the initial weights,
    and the march jitter and grid samples of calls that are given neither
    draws nor a generator.

    ``model`` overrides the NGPModel built from ``model_cfg``: any module
    with ``forward(positions, dirs)``, ``density_raw(positions)`` and
    ``param_list()`` (e.g. models/ori_nerf.OriginNeRFModel, on ``device``)
    trains under the same loop, grid update and checkpoint."""

    def __init__(self, model_cfg: NGPModelConfig, rcfg: NGPRenderConfig,
                 cfg: NGPTrainConfig, generator: torch.Generator, device="cuda",
                 camera_c2w: Optional[torch.Tensor] = None,
                 focal: Optional[torch.Tensor] = None,
                 image_wh: Optional[Tuple[int, int]] = None,
                 loss_fn=None, model: Optional[torch.nn.Module] = None, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self.rcfg = rcfg
        self.cfg = cfg
        self.generator = generator
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
        self.model = (model if model is not None else
                      NGPModel(model_cfg, device=self.device, generator=generator))
        occ_state = occ.init_occupancy(self.occ_cfg, self.device)
        if camera_c2w is not None:
            grid0 = occ.mark_untrained(self.occ_cfg, camera_c2w.to(self.device),
                                       focal.to(self.device), image_wh[0],
                                       image_wh[1])
            occ_state = occ_state._replace(density_grid=grid0)
        self.state = NGPTrainState(params=self.model,
                                   opt_state=init_adam(self.model.param_list()),
                                   occ=occ_state, step=0)
        self.grid_update = occ.make_density_grid_update(
            self.occ_cfg, self.model.density_raw, cfg.n_grid_uniform,
            cfg.n_grid_nonuniform, aabb=rcfg.aabb)
        self.n_rays_per_batch = cfg.n_rays_per_batch
        self._measured_samples = 0.0
        self._measure_count = 0
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

    # -- one train step, in the three stages a profile separates -----------

    def forward(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                target: torch.Tensor, bg: torch.Tensor, xi: torch.Tensor):
        """March, field and composite with the training budget (n_compact
        samples per ray). Returns (mean loss, NGPRenderOut)."""
        out = render_rays_ngp(self.occ_cfg, self.rcfg, self.model, self.state.occ,
                              rays_o, rays_d, bg, xi,
                              density_apply=self.model.density_raw)
        with span("ngp.loss"):
            return self.loss_fn(out.rgb, target).mean(), out

    def backward(self, loss: torch.Tensor) -> List[torch.Tensor]:
        params = self.model.param_list()
        with span("ngp.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        """apply_param_update on the live parameters (copied in place);
        returns the all-finite flag (None without skip_nonfinite)."""
        params = self.model.param_list()
        st = self.state
        with span("ngp.update"):
            new, opt_state, finite = apply_param_update(
                self.cfg, [p.detach() for p in params], st.opt_state, st.step, grads)
            for p, n in zip(params, new):
                p.copy_(n)
        self.state = st._replace(opt_state=opt_state, step=st.step + 1)
        return finite

    # -- the mesh's hooks ---------------------------------------------------

    def reduce_gradients(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean of each gradient over the mesh axis the model names for
        it (``model.grad_axes()``; default "world": every rank holds the
        parameter and sees its own rays, or the same rays as its model
        group). One bucket per axis."""
        axes = (self.model.grad_axes() if hasattr(self.model, "grad_axes")
                else ["world"] * len(grads))
        out = list(grads)
        for axis in ("world", "data"):
            idx = [i for i, a in enumerate(axes) if a == axis]
            for i, g in zip(idx, mesh_lib.all_reduce_mean(self.mesh, [out[i] for i in idx],
                                                          axis)):
                out[i] = g
        return out

    def _step(self, rays_o, rays_d, target, bg, xi) -> Dict[str, torch.Tensor]:
        with span("ngp.step"):
            with torch.enable_grad():
                loss, out = self.forward(rays_o, rays_d, target, bg, xi)
                grads = self.backward(loss)
            loss, n_samples = loss.detach(), out.n_samples
            with torch.no_grad():
                mse = torch.mean((out.rgb - target) ** 2)
            if self.mesh is not None:
                grads = self.reduce_gradients(grads)
                # the global batch's metrics: its mean loss and mse, and its
                # samples (summed over the data shards: the batch adaptation
                # then reads one count on every rank and picks one rung)
                loss, mse = mesh_lib.all_reduce_mean(self.mesh, [loss, mse], "world")
                (n_samples,) = mesh_lib.all_reduce_sum(self.mesh, [n_samples], "data")
            finite = self.update(grads)
            return {"loss": loss, "psnr": mse2psnr(mse), "n_samples": n_samples,
                    "finite": (torch.ones((), dtype=torch.bool, device=loss.device)
                               if finite is None else finite)}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def train_block(self, rays_o, rays_d, target, bg=None, xi=None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """Run S = rays_o.shape[0] steps, one after another.

        rays_o/rays_d/target [S, B, 3]; bg [S, B, 3] or anything that
        broadcasts to it (default: cfg.background_color); xi [S, B, 1], or
        drawn per step from ``generator`` (default: the trainer's). Callers
        align S with update_den_freq and run the occupancy update between
        blocks (run_net.train_loop). Returns each metric stacked over the
        S steps (the last entry is the JAX package's block metric)."""
        S, B = rays_o.shape[:2]
        self._apply_march_schedule()
        self.host_step += S
        with span("ngp.h2d"):
            rays_o, rays_d, target = map(self._tensor, (rays_o, rays_d, target))
            bg = self._tensor(self.cfg.background_color if bg is None else bg)
        bg = bg.expand(S, B, 3)
        gen = generator or self.generator
        steps = []
        for s in range(S):
            xs = (self._tensor(xi[s]) if xi is not None else
                  torch.rand((B, 1), generator=gen, device=self.device))
            steps.append(self._step(rays_o[s], rays_d[s], target[s], bg[s], xs))
        metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        self._measured_samples = self._measured_samples + metrics["n_samples"].sum()
        self._measure_count += S
        return metrics

    def train_step(self, rays_o, rays_d, target, bg_color=None, xi=None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step with the grid update and batch adaptation on the
        update_den_freq cadence (the JAX package's train_step)."""
        cfg = self.cfg
        self._apply_march_schedule()
        self.host_step += 1
        it = self.state.step
        gen = generator or self.generator
        if it % cfg.update_den_freq == 0:
            self.state = self.state._replace(
                occ=self.grid_update(self.state.occ, gen))
        B = rays_o.shape[0]
        bg = self._tensor(cfg.background_color if bg_color is None else bg_color)
        xs = (self._tensor(xi) if xi is not None else
              torch.rand((B, 1), generator=gen, device=self.device))
        metrics = self._step(self._tensor(rays_o), self._tensor(rays_d),
                             self._tensor(target), bg.expand(B, 3), xs)
        self._measured_samples = self._measured_samples + metrics["n_samples"]
        self._measure_count += 1
        if it % cfg.update_den_freq == cfg.update_den_freq - 1:
            self._update_batch_rays()
        return metrics

    def _update_batch_rays(self) -> None:
        """Resize the ray batch toward target_batch_size samples
        (update_batch_rays, density_grid_sampler.py:262-267), snapped down to
        the JAX package's quarter-octave ladder. Reads the measured sample
        count from the device: one sync per call. Under a mesh the count is
        the global batch's (each step's n_samples is summed over the data
        shards), so every rank picks the same rung and ``n_rays_per_batch``
        is the global batch."""
        with span("ngp.adapt_batch"):
            measured = max(float(self._measured_samples)
                           / max(self._measure_count, 1), 1.0)
        rays = int(self.n_rays_per_batch * self.cfg.target_batch_size / measured)
        rays = max(128, min(rays, self.cfg.target_batch_size))
        self.n_rays_per_batch = _ladder_floor(rays)
        self._measured_samples = 0.0
        self._measure_count = 0

    @torch.no_grad()
    def render_image(self, pose_c2w: torch.Tensor, intr: torch.Tensor,
                     H: int, W: int, chunk: int = 4096
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunked full-image render (Runner.render_img, runner.py:195-228).
        Returns (rgb [H, W, 3], depth [H, W])."""
        from ..geom import rays as rays_lib

        with span("ngp.frame"):
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
                with span("ngp.chunk"):
                    out = render_rays_ngp(self.occ_cfg, self.rcfg, self.model,
                                          self.state.occ, rays_o[s:s + chunk],
                                          rays_d[s:s + chunk], bg)
                    rgbs.append(out.rgb)
                    depths.append(out.depth)
            rgb = torch.cat(rgbs)[:n].reshape(H, W, 3)
            depth = torch.cat(depths)[:n].reshape(H, W)
            return rgb, depth
