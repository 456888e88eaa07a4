"""Cascaded occupancy grid: state + update rules (counterpart of
myc_nerfs_tpu/render/occupancy.py).

jnerf's density-grid maintenance (density_grid_sampler.py:200-260 and its
CUDA kernels): mark_untrained, generate_grid_samples, a scatter-max splat,
an EMA update and update_bitfield. Layout: row-major [cascade, ix, iy, iz]
tensors, as in the JAX package.

Randomness: ``generate_grid_samples`` takes its three draws (cascade level,
base probe, jitter) as arguments; the grid update makes them from a
``torch.Generator`` unless it is handed draws, so tests can feed both
packages the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span

SQRT3 = 1.73205080757
NERF_GRIDSIZE = 128
NERF_MIN_OPTICAL_THICKNESS = 0.01
PROBE_STRIDE = 19349663   # the reference's linear re-hash of probe indices
PROBE_OFFSET = 96925573
N_PROBES = 10


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    grid_size: int = NERF_GRIDSIZE
    n_cascades: int = 5
    max_cascade: int = 0            # from aabb_scale: 1<<max_cascade >= aabb_scale
    decay: float = 0.95
    max_steps: int = 1024           # NERF_STEPS
    n_training_steps: int = 16      # grid update cadence

    @property
    def min_cone_stepsize(self) -> float:
        return SQRT3 / self.max_steps


class OccupancyState(NamedTuple):
    density_grid: torch.Tensor   # [C, G, G, G] float32 (-1 marks untrained)
    bitfield: torch.Tensor       # [C, G, G, G] bool
    mean_density: torch.Tensor   # scalar float32
    ema_step: torch.Tensor       # scalar int32


class GridDraws(NamedTuple):
    """The random numbers of one generate_grid_samples call."""

    level: torch.Tensor   # [n] int, cascade in [0, max_cascade]
    base: torch.Tensor    # [n] int, first probe in [0, G^3)
    jitter: torch.Tensor  # [n, 3] float32 in [0, 1)


def init_occupancy(cfg: OccupancyConfig, device=None) -> OccupancyState:
    G, C = cfg.grid_size, cfg.n_cascades
    return OccupancyState(
        density_grid=torch.zeros((C, G, G, G), device=device),
        bitfield=torch.zeros((C, G, G, G), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device),
        ema_step=torch.zeros((), dtype=torch.int32, device=device))


def cell_centers(cfg: OccupancyConfig, level: int, device=None) -> torch.Tensor:
    """World positions of all cell centres at one cascade [G, G, G, 3]:
    ((i + 0.5)/G - 0.5) * 2^level + 0.5."""
    G = cfg.grid_size
    idx = (torch.arange(G, dtype=torch.float32, device=device) + 0.5) / G - 0.5
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    return torch.stack([x, y, z], -1) * (2.0 ** level) + 0.5


def mark_untrained(cfg: OccupancyConfig, c2w: torch.Tensor, focal: torch.Tensor,
                   W: int, H: int) -> torch.Tensor:
    """Initial density grid with -1 in cells seen by no camera.

    c2w [n_img, 3, 4] NGP-convention camera-to-world; focal [n_img, 2].
    Cameras are visited one at a time, so memory stays at one cascade.
    """
    G, C = cfg.grid_size, cfg.n_cascades
    levels = []
    for level in range(C):
        pos = cell_centers(cfg, level, c2w.device).reshape(-1, 3)
        radius = 0.5 * SQRT3 * (2.0 ** level) / G
        seen = torch.zeros(pos.shape[0], dtype=torch.bool, device=c2w.device)
        for n in range(c2w.shape[0]):
            xyz = (pos - c2w[n, :, 3]) @ c2w[n, :, :3]
            x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            seen |= ((z > 0)
                     & (torch.abs(x) - radius < z / focal[n, 0] * (W * 0.5))
                     & (torch.abs(y) - radius < z / focal[n, 1] * (H * 0.5)))
        levels.append(torch.where(seen, 0.0, -1.0).reshape(G, G, G))
    return torch.stack(levels)


def draw_grid_samples(cfg: OccupancyConfig, n_samples: int,
                      generator: torch.Generator, device=None) -> GridDraws:
    G = cfg.grid_size
    level = torch.randint(0, cfg.max_cascade + 1, (n_samples,),
                          generator=generator, device=device)
    base = torch.randint(0, G * G * G, (n_samples,), generator=generator,
                         device=device)
    jitter = torch.rand((n_samples, 3), generator=generator, device=device)
    return GridDraws(level=level, base=base, jitter=jitter)


def generate_grid_samples(cfg: OccupancyConfig, state: OccupancyState,
                          draws: GridDraws, thresh: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random (position, flat cell index) pairs biased to occupied cells.

    jnerf generate_grid_samples_nerf_nonuniform.h: per sample, probe up to
    10 scrambled cell indices of its cascade and take the first whose grid
    value exceeds ``thresh`` (else the last probe). Returns (positions
    [n, 3] world, indices [n] flat into [C, G^3]).
    """
    G = cfg.grid_size
    n_cells = G * G * G
    level = draws.level.to(torch.int64)
    base = draws.base.to(torch.int64)
    grid_flat = state.density_grid.reshape(cfg.n_cascades, -1)
    steps = torch.arange(N_PROBES, dtype=torch.int64, device=base.device)
    probes = (base[:, None] + steps[None, :] * PROBE_STRIDE + PROBE_OFFSET) % n_cells
    hit = grid_flat[level[:, None], probes] > thresh
    first = hit.to(torch.uint8).argmax(dim=1)
    pos_idx = torch.where(hit.any(dim=1),
                          torch.gather(probes, 1, first[:, None])[:, 0],
                          probes[:, -1])
    cell = torch.stack([pos_idx // (G * G), (pos_idx // G) % G, pos_idx % G],
                       -1).to(torch.float32)
    mip_scale = torch.exp2(level.to(torch.float32))[:, None]
    pos = ((cell + draws.jitter) / G - 0.5) * mip_scale + 0.5
    return pos, level * n_cells + pos_idx


def splat_max(cfg: OccupancyConfig, tmp_grid: torch.Tensor,
              flat_idx: torch.Tensor, raw_density: torch.Tensor) -> torch.Tensor:
    """Scatter-max exp(min(raw, 30)) * MIN_CONE_STEPSIZE into tmp_grid
    (updated in place and returned)."""
    optical = torch.exp(torch.clamp_max(raw_density, 30.0)) * cfg.min_cone_stepsize
    tmp_grid.view(-1).scatter_reduce_(0, flat_idx, optical.to(tmp_grid.dtype),
                                      reduce="amax", include_self=True)
    return tmp_grid


def ema_update(cfg: OccupancyConfig, grid: torch.Tensor, tmp: torch.Tensor
               ) -> torch.Tensor:
    """grid = max(grid * decay, tmp); untrained (-1) cells stay."""
    return torch.where(grid < 0.0, grid, torch.maximum(grid * cfg.decay, tmp))


def update_bitfield(cfg: OccupancyConfig, grid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bitfield, mean) from the density grid (jnerf update_bitfield.h).

    mean over cascade 0; thresh = min(0.01, mean); each cascade's bits are
    ORed with the 2x max-pool of the previous cascade placed in its centre
    octant.
    """
    G = cfg.grid_size
    mean = torch.clamp_min(grid[0], 0.0).mean()
    thresh = torch.clamp_max(mean, NERF_MIN_OPTICAL_THICKNESS)
    bits = grid > thresh
    lo, hi = G // 4, G // 4 + G // 2
    out = [bits[0]]
    for lv in range(1, cfg.n_cascades):
        pooled = out[lv - 1].reshape(G // 2, 2, G // 2, 2, G // 2, 2)
        pooled = pooled.any(5).any(3).any(1)
        cur = bits[lv].clone()
        cur[lo:hi, lo:hi, lo:hi] |= pooled
        out.append(cur)
    return torch.stack(out), mean


def make_density_grid_update(cfg: OccupancyConfig, density_raw_fn: Callable,
                             n_uniform: int, n_nonuniform: int,
                             aabb: Tuple[float, float] = (0.0, 1.0)):
    """Build the grid-update step (jnerf update_density_grid_nerf,
    density_grid_sampler.py:200-246).

    ``density_raw_fn(positions [n, 3]) -> raw density [n, 1]``; positions
    are warped into [0, 1] over ``aabb``, the renderer's AABB. The returned
    ``update(state, generator=None, draws=None)`` draws the uniform and the
    nonuniform samples from ``generator`` unless ``draws`` (a pair of
    GridDraws, the second None when n_nonuniform is 0) is given.
    """
    if density_raw_fn is None:
        raise ValueError("make_density_grid_update requires a density fn")
    lo, hi = aabb

    @torch.no_grad()
    def update(state: OccupancyState, generator: Optional[torch.Generator] = None,
               draws: Optional[Tuple[GridDraws, Optional[GridDraws]]] = None
               ) -> OccupancyState:
        with span("ngp.grid_update"):
            device = state.density_grid.device
            if draws is None:
                if generator is None:
                    raise ValueError("grid update needs a generator or draws")
                draws = (draw_grid_samples(cfg, n_uniform, generator, device),
                         draw_grid_samples(cfg, n_nonuniform, generator, device)
                         if n_nonuniform else None)
            pos, idx = generate_grid_samples(cfg, state, draws[0], -0.01)
            if n_nonuniform:
                pos_n, idx_n = generate_grid_samples(cfg, state, draws[1],
                                                     NERF_MIN_OPTICAL_THICKNESS)
                pos, idx = torch.cat([pos, pos_n]), torch.cat([idx, idx_n])
            warped = torch.clamp((pos - lo) / (hi - lo), 0.0, 1.0)
            raw = density_raw_fn(warped)[..., 0]
            tmp = splat_max(cfg, torch.zeros_like(state.density_grid), idx, raw)
            grid = ema_update(cfg, state.density_grid, tmp)
            bitfield, mean = update_bitfield(cfg, grid)
            return OccupancyState(density_grid=grid, bitfield=bitfield,
                                  mean_density=mean, ema_step=state.ema_step + 1)

    return update


def mip_from_pos(cfg: OccupancyConfig, pos: torch.Tensor) -> torch.Tensor:
    """Smallest cascade containing pos (jnerf ray_sampler_header.h:60-66)."""
    maxval = torch.abs(pos - 0.5).amax(-1)
    exponent = torch.floor(torch.log2(torch.clamp_min(maxval, 1e-10))) + 1
    return torch.clamp(exponent.to(torch.int32) + 1, 0, cfg.n_cascades - 1)


def grid_value_at(cfg: OccupancyConfig, volume: torch.Tensor, pos: torch.Tensor,
                  mip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Value of a cascaded [C, G, G, G] volume at world pos [..., 3]: one
    flat gather. ``mip=None`` reads cascade 0 without mip math. The int
    cast truncates toward zero, like the JAX package's astype(int32)."""
    G = cfg.grid_size
    if mip is None:
        i = torch.clamp((pos * G).to(torch.int32), 0, G - 1).to(torch.int64)
        return volume[0].reshape(-1)[(i[..., 0] * G + i[..., 1]) * G + i[..., 2]]
    mip_scale = torch.exp2(-mip.to(torch.float32))[..., None]
    p = (pos - 0.5) * mip_scale + 0.5
    i = torch.clamp((p * G).to(torch.int32), 0, G - 1).to(torch.int64)
    g3 = G * G * G
    return volume.reshape(-1)[mip.to(torch.int64) * g3
                              + (i[..., 0] * G + i[..., 1]) * G + i[..., 2]]


def occupied_at(cfg: OccupancyConfig, bitfield: torch.Tensor, pos: torch.Tensor,
                mip: torch.Tensor) -> torch.Tensor:
    """Bitfield lookup at world pos [..., 3] for cascade mip [...]."""
    return grid_value_at(cfg, bitfield, pos, mip)


def sigma_at(cfg: OccupancyConfig, density_grid: torch.Tensor, pos: torch.Tensor,
             mip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Density estimate at world pos from the maintained grid (stored
    optical thickness / MIN_CONE_STEPSIZE; untrained cells read 0)."""
    v = grid_value_at(cfg, density_grid, pos, mip)
    return torch.clamp_min(v, 0.0) / cfg.min_cone_stepsize


def occupied_at_mip0(cfg: OccupancyConfig, bitfield: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Cascade-0 bitfield lookup (single-cascade scenes)."""
    return grid_value_at(cfg, bitfield, pos)
