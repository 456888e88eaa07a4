"""NGP ray marching + rendering (counterpart of
myc_nerfs_tpu/render/ngp_render.py).

The fused march (default): pass 1 probes the density grid at n_coarse
uniform depths inside the ray/AABB intersection, decides occupancy with the
bitfield threshold and keeps a coarse transmittance; pass 2 places K
samples by inverse CDF over the live bins (jnerf RaySampler, CompactedCoord
and CalcRgb folded into one static-shape pass). With ``fused_march=False``
the two-pass bitfield march (``march_rays``) places n_samples per ray, and
in training ``compact_marched`` keeps the first n_compact samples before
the transmittance falls below eps, from the density grid
(``compact_source='grid'``) or from a detached density forward of the
network (``'network'``, the reference's CompactedCoord). The samples go
through the field and the NGP compositor.

Positions are warped to [0, 1] over the cascade AABB and directions to
[0, 1], as the network expects (ray_sampler_header.h:790-822).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.ngp import density_activation, rgb_activation
from ..ops.compaction import compact_first_k
from .composite import composite_rgb, composite_weights
from .occupancy import (OccupancyConfig, OccupancyState, grid_value_at, mip_from_pos,
                        occupied_at, occupied_at_mip0, sigma_at)

SQRT3 = 1.7320508075688772
MAX_STEP = 1024  # NERF_STEPS (density_grid_sampler.py:38)


@dataclasses.dataclass(frozen=True)
class NGPRenderConfig:
    """Same fields and defaults as the JAX NGPRenderConfig."""

    aabb_scale: int = 1
    n_coarse: int = 512
    n_samples: int = 64
    near_distance: float = 0.2
    cone_angle_constant: float = 0.00390625
    const_dt: bool = True
    early_stop_eps: float = 1e-4
    n_compact: int = 20
    compact_source: str = "grid"
    fused_march: bool = True

    @property
    def aabb(self) -> Tuple[float, float]:
        s = self.aabb_scale
        return (0.5 - s / 2.0, 0.5 + s / 2.0)

    @property
    def min_stepsize(self) -> float:
        """MIN_CONE_STEPSIZE = SQRT3/NERF_STEPS (ray_sampler_header.h:100-101)."""
        return SQRT3 / MAX_STEP


def calc_dt(rcfg: NGPRenderConfig, n_cascades: int, grid_size: int,
            t: torch.Tensor) -> torch.Tensor:
    """Per-sample step size (ray_sampler_header.h:106-111)."""
    mn = rcfg.min_stepsize
    if rcfg.const_dt:
        return torch.full_like(t, mn * 0.5)
    mx = mn * (1 << (n_cascades - 1)) * MAX_STEP / grid_size
    return torch.clamp(t * rcfg.cone_angle_constant, mn, mx)


class MarchedRays(NamedTuple):
    positions: torch.Tensor  # [N, K, 3] warped to [0, 1]
    dirs: torch.Tensor       # [N, K, 3] warped to [0, 1]
    dt: torch.Tensor         # [N, K] metric step sizes
    t: torch.Tensor          # [N, K] metric depths
    valid: torch.Tensor      # [N, K] bool


def ray_aabb_range(rcfg: NGPRenderConfig, rays_o: torch.Tensor,
                   rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry/exit t of the cascade AABB, entry clamped to near_distance."""
    lo, hi = rcfg.aabb
    inv = 1.0 / torch.where(rays_d == 0, 1e-10, rays_d)
    t1 = (lo - rays_o) * inv
    t2 = (hi - rays_o) * inv
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    tmin = torch.clamp_min(tmin, rcfg.near_distance)
    tmax = torch.maximum(tmax, tmin)
    return tmin, tmax


def march_rays(occ_cfg: OccupancyConfig, rcfg: NGPRenderConfig,
               bitfield: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
               xi: Optional[torch.Tensor] = None) -> MarchedRays:
    """Two-pass occupancy-gated march (jnerf rays_sampler, ray_sampler.h):
    pass 1 probes the bitfield at n_coarse uniform depths, pass 2 places
    rcfg.n_samples samples by inverse CDF over the occupied bins, each
    re-checked against the bitfield. ``xi`` [N, 1] is the per-ray jitter
    (the JAX package draws it from ``key``; None: 0.5)."""
    tmin, tmax = ray_aabb_range(rcfg, rays_o, rays_d)
    span = tmax - tmin

    def lookup(pos):
        if rcfg.aabb_scale == 1:
            return occupied_at_mip0(occ_cfg, bitfield, pos)
        return occupied_at(occ_cfg, bitfield, pos, mip_from_pos(occ_cfg, pos))

    Mc = rcfg.n_coarse
    frac = (torch.arange(Mc, dtype=torch.float32, device=rays_o.device) + 0.5) / Mc
    tc = tmin[:, None] + span[:, None] * frac[None, :]
    pos_c = rays_o[:, None, :] + rays_d[:, None, :] * tc[..., None]
    return _place_samples(occ_cfg, rcfg, rays_o, rays_d, tmin, span, span / Mc,
                          lookup(pos_c), rcfg.n_samples, xi, lookup)


def compact_marched(marched: MarchedRays, sigma_det: torch.Tensor, n_compact: int,
                    eps: float = 1e-4) -> MarchedRays:
    """Early-termination compaction (CompactedCoord, compacted_coord.h:39-77):
    per ray the first n_compact valid samples whose transmittance before
    them is above eps, from the detached density ``sigma_det`` [N, K];
    positions, t and dt gathered, dirs the ray's own."""
    N = sigma_det.shape[0]
    alpha = 1.0 - torch.exp(-sigma_det * marched.dt)
    alpha = torch.where(marched.valid, alpha, 0.0)
    log1ma = torch.log1p(-torch.clamp_max(alpha, 1.0 - 1e-7))
    logT_prev = torch.cat([torch.zeros((N, 1), device=sigma_det.device),
                           torch.cumsum(log1ma, dim=-1)[:, :-1]], dim=-1)
    surv = marched.valid & (torch.exp(logT_prev) > eps)
    idx, valid = compact_first_k(surv, n_compact)
    packed = torch.cat([marched.positions, marched.t[..., None],
                        marched.dt[..., None]], dim=-1)                   # [N, K, 5]
    taken = torch.gather(packed, 1, idx[..., None].expand(*idx.shape, 5))  # [N, M, 5]
    dirs = marched.dirs[:, :1].expand(taken[..., :3].shape)
    return MarchedRays(positions=taken[..., :3], dirs=dirs, dt=taken[..., 4],
                       t=taken[..., 3], valid=valid)


def _place_samples(occ_cfg: OccupancyConfig, rcfg: NGPRenderConfig,
                   rays_o: torch.Tensor, rays_d: torch.Tensor,
                   tmin: torch.Tensor, span: torch.Tensor, wb: torch.Tensor,
                   mask: torch.Tensor, K: int, xi: Optional[torch.Tensor],
                   sample_check: Callable) -> MarchedRays:
    """Inverse-CDF placement of K samples over the masked coarse bins, then
    the AABB warp.

    The arc-rank of sample k is (k + xi) * dt in live-bin units; its bin is
    the count of cumulative live-bin counts <= that rank, found with
    searchsorted at [N, K] size (the JAX package compares [N, K, n_coarse]).
    ``xi`` [N, 1] is the per-ray jitter (None: 0.5, the render setting).
    """
    any_occ = mask.any(dim=1)
    c = torch.cumsum(mask.to(torch.float32), dim=1)          # [N, Mc]
    n_occ = c[:, -1]
    arc = n_occ * wb
    dt_ref = calc_dt(rcfg, occ_cfg.n_cascades, occ_cfg.grid_size,
                     tmin + 0.5 * span)
    dt = torch.maximum(arc / K, dt_ref)                       # [N]
    if xi is None:
        xi = 0.5
    hit = span > 0.0
    inv_wb = torch.where(hit, 1.0 / torch.where(hit, wb, 1.0), 0.0)
    ks = torch.arange(K, dtype=torch.float32, device=rays_o.device)[None, :]
    r = (ks + xi) * (dt * inv_wb)[:, None]                    # [N, K]
    bin_idx = torch.searchsorted(c, r, right=True).to(torch.float32)
    t = tmin[:, None] + (bin_idx + (r - torch.floor(r))) * wb[:, None]
    valid_budget = r < n_occ[:, None]

    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    lo, hi = rcfg.aabb
    inbox = ((pos >= lo) & (pos <= hi)).all(-1)
    valid = (sample_check(pos) & inbox & any_occ[:, None] & valid_budget
             & hit[:, None])
    warped_pos = torch.clamp((pos - lo) / (hi - lo), 0.0, 1.0)
    warped_dir = ((rays_d[:, None, :] + 1.0) * 0.5).expand(pos.shape)
    return MarchedRays(positions=warped_pos, dirs=warped_dir,
                       dt=dt[:, None].expand(t.shape), t=t, valid=valid)


def _sigma_probe(occ_cfg: OccupancyConfig, density_grid: torch.Tensor,
                 pos: torch.Tensor, single_mip: bool) -> torch.Tensor:
    """Density-grid value at world pos [..., 3]; ``> thresh`` is exactly
    the bitfield bit (both go through grid_value_at)."""
    return grid_value_at(occ_cfg, density_grid, pos,
                         None if single_mip else mip_from_pos(occ_cfg, pos))


def march_rays_fused(occ_cfg: OccupancyConfig, rcfg: NGPRenderConfig,
                     occ_state: OccupancyState, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, xi: Optional[torch.Tensor] = None,
                     n_samples: Optional[int] = None,
                     trunc_eps: Optional[float] = None) -> MarchedRays:
    """March + coarse transmittance truncation in one pass over the density
    grid: bins whose coarse transmittance has fallen below trunc_eps are
    excluded from sample placement (CompactedCoord folded into RaySampler)."""
    N = rays_o.shape[0]
    K = n_samples or rcfg.n_samples
    eps = rcfg.early_stop_eps if trunc_eps is None else trunc_eps
    tmin, tmax = ray_aabb_range(rcfg, rays_o, rays_d)
    span = tmax - tmin
    single_mip = rcfg.aabb_scale == 1
    thresh = torch.clamp_max(occ_state.mean_density, 0.01)

    Mc = rcfg.n_coarse
    frac = (torch.arange(Mc, dtype=torch.float32, device=rays_o.device) + 0.5) / Mc
    tc = tmin[:, None] + span[:, None] * frac[None, :]
    pos_c = rays_o[:, None, :] + rays_d[:, None, :] * tc[..., None]
    gval = _sigma_probe(occ_cfg, occ_state.density_grid, pos_c, single_mip)
    occ_c = gval > thresh
    wb = span / Mc

    sigma_c = torch.clamp_min(gval, 0.0) * (1.0 / occ_cfg.min_cone_stepsize)
    od = torch.where(occ_c, sigma_c * wb[:, None], 0.0)
    logT_prev = torch.cat([torch.zeros((N, 1), device=rays_o.device),
                           -torch.cumsum(od, dim=1)[:, :-1]], dim=1)
    # log(eps) in f32, like the JAX package's jnp.log(eps)
    live = (occ_c & (logT_prev > float(np.log(np.float32(eps)))) if eps > 0
            else occ_c)

    def check(pos):
        return _sigma_probe(occ_cfg, occ_state.density_grid, pos, single_mip) > thresh

    return _place_samples(occ_cfg, rcfg, rays_o, rays_d, tmin, span, wb, live,
                          K, xi, check)


class NGPRenderOut(NamedTuple):
    rgb: torch.Tensor        # [N, 3]
    depth: torch.Tensor      # [N]
    opacity: torch.Tensor    # [N]
    n_samples: torch.Tensor  # scalar: total valid samples


def render_marched(model_apply: Callable, marched: MarchedRays,
                   bg_color: torch.Tensor, early_stop_eps: float = 1e-4
                   ) -> NGPRenderOut:
    """Evaluate the field on marched samples and composite (CalcRgb fwd).

    ``model_apply(positions [M, 3], dirs [M, 3]) -> raw [M, 4]``: raw rgb
    (sigmoid here) and raw density (exp here).
    """
    N, K, _ = marched.positions.shape
    raw = model_apply(marched.positions.reshape(-1, 3),
                      marched.dirs.reshape(-1, 3)).reshape(N, K, 4)
    return composite_marched(raw, marched, bg_color, early_stop_eps)


def composite_marched(raw: torch.Tensor, marched: MarchedRays,
                      bg_color: torch.Tensor, early_stop_eps: float = 1e-4
                      ) -> NGPRenderOut:
    """Composite the field's raw [N, K, 4] on marched samples (CalcRgb fwd)."""
    sigma = density_activation(raw[..., 3])
    rgb_s = rgb_activation(raw[..., :3])
    weights, t_left = composite_weights(sigma, marched.dt, marched.valid,
                                        early_stop_eps)
    rgb = composite_rgb(rgb_s, weights, t_left, bg_color)
    depth = (weights * marched.t).sum(-1)
    return NGPRenderOut(rgb=rgb, depth=depth, opacity=1.0 - t_left[..., 0],
                        n_samples=marched.valid.sum())


def render_rays_ngp(occ_cfg: OccupancyConfig, rcfg: NGPRenderConfig,
                    model_apply: Callable, occ_state: OccupancyState,
                    rays_o: torch.Tensor, rays_d: torch.Tensor,
                    bg_color: torch.Tensor, xi: Optional[torch.Tensor] = None,
                    density_apply: Optional[Callable] = None) -> NGPRenderOut:
    """March + field + composite (DensityGridSampler.sample + rays2rgb).

    With ``density_apply`` and rcfg.n_compact > 0 (training) the fused march
    places n_compact samples per ray, else n_samples. With
    ``fused_march=False``, or in training with ``compact_source='network'``,
    the bitfield march places n_samples, and in training compact_marched
    keeps n_compact of them, by the density grid ('grid') or by
    ``density_apply``'s detached density ('network').
    """
    compacting = density_apply is not None and rcfg.n_compact > 0
    if rcfg.fused_march and not (compacting and rcfg.compact_source == "network"):
        K = rcfg.n_compact if compacting else rcfg.n_samples
        marched = march_rays_fused(occ_cfg, rcfg, occ_state, rays_o, rays_d, xi,
                                   n_samples=K)
        return render_marched(model_apply, marched, bg_color, rcfg.early_stop_eps)
    marched = march_rays(occ_cfg, rcfg, occ_state.bitfield, rays_o, rays_d, xi)
    if compacting:
        N, K, _ = marched.positions.shape
        if rcfg.compact_source == "grid":
            lo, hi = rcfg.aabb
            world = marched.positions * (hi - lo) + lo  # un-warp
            mip = None if rcfg.aabb_scale == 1 else mip_from_pos(occ_cfg, world)
            sigma_det = sigma_at(occ_cfg, occ_state.density_grid, world, mip)
        else:
            with torch.no_grad():
                raw = density_apply(marched.positions.reshape(-1, 3))
                sigma_det = density_activation(raw.reshape(N, K))
        marched = compact_marched(marched, sigma_det, rcfg.n_compact, rcfg.early_stop_eps)
    return render_marched(model_apply, marched, bg_color, rcfg.early_stop_eps)
