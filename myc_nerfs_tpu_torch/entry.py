"""Entry point: one forward render step of the flagship Instant-NGP model
(counterpart of __graft_entry__.py's ``_flagship`` and ``entry``).

    from myc_nerfs_tpu_torch.entry import entry
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    rgb = fn(*args)             # [1024, 3]

The model is the full 16-level L16F2 ``brick3`` grid (HashGridConfig()'s
defaults) with the two NGP MLPs through the fused kernels; the occupancy
grid holds a central ball of radius 0.3 so the march finds work; 1024
rays on a circle of radius 1.4 look at the box's centre; n_coarse 256,
n_samples 32. The weights come from a seeded generator. On the card the
render launches ``brick_encode`` and ``fused_mlp``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .models.ngp import HashGridConfig, NGPModel, NGPModelConfig
from .render import occupancy as occ
from .render.ngp_render import NGPRenderConfig, render_rays_ngp

N_RAYS = 1024


def _flagship(device, generator: torch.Generator):
    model = NGPModel(NGPModelConfig(grid=HashGridConfig()), device=device, generator=generator)
    rcfg = NGPRenderConfig(aabb_scale=1, n_coarse=256, n_samples=32)
    return model, rcfg, occ.OccupancyConfig()


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """(fn, args): ``fn(model, occ_state, rays_o, rays_d) -> rgb [N, 3]``
    renders the rays without gradients."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("entry: torch.cuda.is_available() is false; call entry('cpu') to "
                         "run on the CPU")
    model, rcfg, occ_cfg = _flagship(device, torch.Generator(device=device).manual_seed(0))
    state = occ.init_occupancy(occ_cfg, device)
    centers = occ.cell_centers(occ_cfg, 0, device)
    ball = torch.linalg.norm(centers - 0.5, dim=-1) < 0.3
    grid = torch.where(ball, 0.05, 0.0)
    density = state.density_grid.clone()
    density[0] = grid
    bitfield = state.bitfield.clone()
    bitfield[0] = ball
    state = state._replace(density_grid=density, bitfield=bitfield,
                           mean_density=torch.clamp_min(grid, 0.0).mean())
    theta = torch.linspace(0.0, 6.28318, N_RAYS, device=device)
    rays_o = torch.stack([0.5 + 1.4 * torch.cos(theta), 0.5 + 1.4 * torch.sin(theta),
                          torch.full((N_RAYS,), 0.5, device=device)], -1)
    rays_d = 0.5 - rays_o
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    bg = torch.ones(3, device=device)

    @torch.no_grad()
    def fn(model, occ_state, rays_o, rays_d):
        return render_rays_ngp(occ_cfg, rcfg, model, occ_state, rays_o, rays_d, bg).rgb

    return fn, (model, state, rays_o, rays_d)


if __name__ == "__main__":
    f, a = entry()
    out = f(*a)
    print("entry ok:", tuple(out.shape), float(out.mean()))
