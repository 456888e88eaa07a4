"""NGP ray marching + rendering, fused march (counterpart of
myc_nerfs_tpu/render/ngp_render.py).

The fused march of the JAX package: pass 1 probes the density grid at
n_coarse uniform depths inside the ray/AABB intersection, decides
occupancy with the bitfield threshold and keeps a coarse transmittance;
pass 2 places K samples by inverse CDF over the live bins. The samples go
through the field and the NGP compositor (jnerf RaySampler, CompactedCoord
and CalcRgb folded into one static-shape pass).

Positions are warped to [0, 1] over the cascade AABB and directions to
[0, 1], as the network expects (ray_sampler_header.h:790-822).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.ngp import density_activation, rgb_activation
from .composite import composite_rgb, composite_weights
from .occupancy import OccupancyConfig, OccupancyState, grid_value_at, mip_from_pos

SQRT3 = 1.7320508075688772
MAX_STEP = 1024  # NERF_STEPS (density_grid_sampler.py:38)


@dataclasses.dataclass(frozen=True)
class NGPRenderConfig:
    """Same fields and defaults as the JAX NGPRenderConfig. Only the fused
    march is ported: ``fused_march=False`` and ``compact_source='network'``
    are refused by render_rays_ngp."""

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
    """Fused march + field + composite (DensityGridSampler.sample + rays2rgb).

    With ``density_apply`` and rcfg.n_compact > 0 (training) the march
    places n_compact samples per ray, else n_samples.
    """
    compacting = density_apply is not None and rcfg.n_compact > 0
    if not rcfg.fused_march or (compacting and rcfg.compact_source == "network"):
        raise NotImplementedError(
            "only the fused march is ported (fused_march=True with "
            "compact_source='grid')")
    K = rcfg.n_compact if compacting else rcfg.n_samples
    marched = march_rays_fused(occ_cfg, rcfg, occ_state, rays_o, rays_d, xi,
                               n_samples=K)
    return render_marched(model_apply, marched, bg_color, rcfg.early_stop_eps)
