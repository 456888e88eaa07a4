"""Entry points: one forward render step of the flagship Instant-NGP model,
and a multi-rank train block (counterparts of __graft_entry__.py's
``_flagship``, ``entry`` and ``dryrun_multichip``).

    from myc_nerfs_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    rgb = fn(*args)             # [1024, 3]
    dryrun_multichip(4)         # 4 ranks, a 2 x 2 mesh; (4, "cpu") on the CPU

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


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """A 4-step NGP train block on ``n_devices`` ranks (parallel/spmd.py):
    a (n/2) x 2 mesh with the hashed brick3 groups split over "model"
    (GroupTPModel) when n is even, else n x 1 with the tables replicated;
    max(128, 16 n) rays per step over "data", every cell occupied, as the
    JAX dry run. On the card one rank per card on NCCL when there are as
    many, else the ranks share the card(s) under gloo. Prints one line and
    returns the last step's loss."""
    import numpy as np

    from .parallel import mesh as mesh_lib
    from .parallel import ranks, spmd

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: torch.cuda.is_available() is false; call "
                         "dryrun_multichip(n, 'cpu') to run on the CPU")
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    table_mode = "groups" if model > 1 else "replicated"
    steps, n_rays = 4, max(128, n_devices * 16)
    ro, rd, tg = spmd.ring_rays(steps * n_rays, seed=1)
    xi = torch.rand((steps * n_rays, 1), generator=torch.Generator().manual_seed(7))
    spec = {k: v.reshape(steps, n_rays, -1).numpy()
            for k, v in dict(rays_o=ro, rays_d=rd, target=tg, xi=xi).items()}
    spec.update(table_mode=table_mode, model_cfg=spmd.block_model_cfg(table_mode))
    ranks.prebuild(device)
    results = mesh_lib.spawn(ranks.ngp_block, n_devices, device, spec, model=model)
    loss = results[0]["loss"][-1]
    if not all(np.isfinite(r["loss"]).all() for r in results):
        raise RuntimeError("NaN loss in multichip dry run")
    print(f"dryrun_multichip({n_devices}): mesh {results[0]['shape']}, "
          f"{steps}-step train block, loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    f, a = entry()
    out = f(*a)
    print("entry ok:", tuple(out.shape), float(out.mean()))
    dryrun_multichip(max(torch.cuda.device_count(), 1))
