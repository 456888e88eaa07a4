"""Test-time photometric pose optimisation (counterpart of
myc_nerfs_tpu/evaluation/test_time_optim.py; barf garf.py:232-269,
evaluate_test_time_photometric_optim).

A fresh se(3) correction per eval image is fitted to the photometric loss
by Adam (optax's semantics, through train/ngp_trainer.adam_step), with the
reference's stops:

- the loss falls below ``stop_loss`` (7e-4 in GARF);
- a plateau: past ``plateau_after`` (1500) iterations, no improvement by
  more than ``improve_eps`` (1e-4) for ``patience`` (200) iterations;
- ``max_iter`` (10000).

The JAX package runs a ``lax.while_loop``. Here a Python loop carries the
same state on the device and freezes it with ``torch.where`` once the stop
condition holds; the host reads that flag every CHECK_EVERY iterations
(one sync each), so the stop iteration and the result are the while loop's.
The pixel draws are an argument: ``draw(it)`` gives iteration it's draws.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..train.ngp_trainer import adam_step, init_adam

CHECK_EVERY = 50  # iterations between host reads of the stop flag

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.adam's defaults


class TTOptResult(NamedTuple):
    se3: torch.Tensor      # [1, 6] the best correction seen
    loss: torch.Tensor     # its loss
    n_iters: torch.Tensor  # int32: iterations run
    reason: str            # "stop_loss", "plateau" or "max_iter"


def test_time_pose_optim(loss_fn: Callable[[torch.Tensor, object], torch.Tensor],
                         draw: Callable[[int], object], lr: float, max_iter: int = 10000,
                         stop_loss: float = 7e-4, plateau_after: int = 1500,
                         patience: int = 200, improve_eps: float = 1e-4,
                         se3_init: Optional[torch.Tensor] = None, device=None
                         ) -> TTOptResult:
    """Fit a [1, 6] se3 correction by Adam with GARF's early stops.

    ``loss_fn(se3, draws)`` renders with the corrected pose and returns the
    scalar loss; ``draw(it)`` gives the draws of iteration it. Order of the
    body, as the JAX package's: the loss and gradient; the best se3 recorded
    before the update (strict compare); the plateau tracker with
    improve_eps; the Adam update. Iteration 0 always runs.
    """
    se3 = (torch.zeros((1, 6), device=device) if se3_init is None
           else se3_init.detach().clone())
    dev = se3.device
    opt = init_adam([se3])
    const_lr = torch.tensor(lr, dtype=torch.float32, device=dev)

    def schedule(count):
        return const_lr

    best, best_l = se3.clone(), torch.tensor(float("inf"), device=dev)
    min_l = torch.tensor(100.0, device=dev)
    min_one = torch.zeros((), dtype=torch.int32, device=dev)
    loss = torch.tensor(100.0, device=dev)
    n_iters = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    for it in range(max(1, max_iter)):
        if it:
            # the while loop's cond on the carry (frozen once it fails)
            not_plateau = (it <= plateau_after) | (it <= min_one + patience)
            active = active & (it < max_iter) & (loss >= stop_loss) & not_plateau
            if it % CHECK_EVERY == 0 and not bool(active):
                break
        x = se3.detach().requires_grad_(True)
        with torch.enable_grad():
            new_loss = loss_fn(x, draw(it))
            (g,) = torch.autograd.grad(new_loss, x, allow_unused=True)
        new_loss = new_loss.detach()
        g = torch.zeros_like(x) if g is None else g
        with torch.no_grad():
            is_best = active & (new_loss < best_l)
            best = torch.where(is_best, se3, best)
            best_l = torch.where(is_best, new_loss, best_l)
            improved = active & (new_loss < min_l - improve_eps)
            min_one = torch.where(improved, torch.tensor(it, dtype=torch.int32, device=dev),
                                  min_one)
            min_l = torch.where(improved, new_loss, min_l)
            (u,), new_opt = adam_step(schedule, ADAM_BETAS, ADAM_EPS, [g], opt)
            se3 = torch.where(active, se3 + u, se3)
            opt = type(opt)(count=torch.where(active, new_opt.count, opt.count),
                            mu=[torch.where(active, new_opt.mu[0], opt.mu[0])],
                            nu=[torch.where(active, new_opt.nu[0], opt.nu[0])])
            loss = torch.where(active, new_loss, loss)
            n_iters = torch.where(active, n_iters + 1, n_iters)
    n = int(n_iters)
    if float(loss) < stop_loss:
        reason = "stop_loss"
    elif n >= max_iter:
        reason = "max_iter"
    else:
        reason = "plateau"
    return TTOptResult(se3=best, loss=best_l, n_iters=n_iters, reason=reason)


def pixel_draws(n_rays: int, n_pixels: int, generator: torch.Generator, device=None
                ) -> Callable[[int], torch.Tensor]:
    """draw(it) -> [n_rays] pixel indices in [0, n_pixels) from ``generator``."""
    def draw(it: int) -> torch.Tensor:
        return torch.randint(0, n_pixels, (n_rays,), generator=generator, device=device)
    return draw


@contextlib.contextmanager
def frozen(params: Sequence[torch.Tensor]):
    """The params' requires_grad off inside the block: a graph recorded
    there differentiates the pose alone (no table or weight gradients)."""
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def make_ngp_pose_loss(occ_cfg, rcfg, model, occ_state, pose_w2c: torch.Tensor,
                       intr: torch.Tensor, image: torch.Tensor, H: int, W: int,
                       world_scale: float = 1.0, world_offset: float = 0.0, bg=None,
                       density_apply=None):
    """The photometric pose loss against a trained NGP field, for
    :func:`test_time_pose_optim`: ``loss_fn(se3, idx)`` renders the pixels
    ``idx`` from se3_to_SE3(se3) o pose_w2c and returns their mean squared
    error against ``image`` [H, W, 3].

    ``pose_w2c`` [3, 4] world->cam; ``world_scale/offset`` map the scene
    into the field's unit AABB. The gradient reaches the pose through the
    march's sample depths and step sizes and through the SH encode of the
    directions (the grid encode stops the position gradient). With
    ``model.param_list()`` the field's parameters are frozen while the loss
    is recorded, so the backward computes no table or weight gradient.
    """
    from ..geom import lie, pose as pose_lib, rays as rays_lib
    from ..render.ngp_render import render_rays_ngp

    dev = pose_w2c.device
    tgt_flat = image.reshape(-1, 3).to(dev)
    grid_all = rays_lib.pixel_grid(H, W, device=dev)
    bg = torch.ones(3, device=dev) if bg is None else torch.as_tensor(bg, device=dev)
    params = model.param_list() if hasattr(model, "param_list") else []

    def loss_fn(se3: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        corr = pose_lib.compose_pair(lie.se3_to_SE3(se3)[0], pose_w2c)
        c, r = rays_lib.get_center_and_ray(corr[None], intr[None], H, W,
                                           xy_grid=grid_all[idx])
        d = r / torch.linalg.norm(r, dim=-1, keepdim=True)
        o = c * world_scale + world_offset
        with frozen(params):
            out = render_rays_ngp(occ_cfg, rcfg, model, occ_state, o[0], d[0], bg, None,
                                  density_apply=density_apply)
        return torch.mean((out.rgb - tgt_flat[idx]) ** 2)

    return loss_fn
