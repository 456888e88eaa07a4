"""TensoRF factor-grid radiance fields: VM-split, VM and CP (counterpart of
myc_nerfs_tpu/models/tensorf.py; tensorf tensorBase.py, tensoRF.py).

- params are a dict keyed as the JAX package's tree: the factor grids
  (``density_plane``/``density_line``/``app_plane``/``app_line`` lists, or
  ``vm_plane``/``vm_line`` for the non-split VM) and ``basis_mat`` are leaf
  tensors; the shading MLP (``mlp``) and the Ref-TensoRF heads and NeRF++
  background net (models/ref_tensorf.py, models/nerfpp.py) are modules;
- upsampling, the AABB shrink and the alpha-mask update are functions
  between training stages that return new params / buffers;
- density is evaluated only at the samples that pass the AABB clip and the
  alpha mask, and appearance only at the samples whose weight passes
  ``ray_march_weight_thres``, by boolean indexing (tensorBase.py:497-518):
  each is one ``nonzero`` (one host sync) per forward. This equals the JAX
  forward with every sample budget at 0;
- the alpha-mask gate is the JAX package's: one lookup in the
  corner-dilated binary volume at ``cell_base_index`` whenever a dilated
  volume exists (a one-voxel superset of the trilinear predicate on the
  clamped border), the trilinear lookup otherwise.

Random draws are arguments: ``sample_ray``'s jitter [N, 1] (``sample_ray_ndc``
[N, S]), as the JAX package draws ``uniform(key, ...)`` inside the step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import cell_base_index, grid_sample_3d, grid_sample_cm, line_sample_cm
from ..ops.sh import eval_sh
from ..render.composite import raw2alpha
from ..utils.profiling import span

MAT_MODE = ((0, 1), (0, 2), (1, 2))  # tensorBase.py:168
VEC_MODE = (2, 1, 0)                 # tensorBase.py:169
# the modules and the basis matrix train at lr_basis; every other key is a
# factor grid at lr_init (tensoRF.py:168-174)
NET_KEYS = ("basis_mat", "mlp", "bg_net", "normal_linear", "diffuse_linear",
            "specular_linear", "rho_linear")


@dataclasses.dataclass(frozen=True)
class TensoRFConfig:
    """The JAX TensoRFConfig's fields and defaults (tensorf opt.py), without
    the sample budgets and the bf16 factor gather (TPU workarounds: the port
    indexes exactly)."""

    decomp: str = "vm_split"                     # vm_split | vm | cp
    density_n_comp: Tuple[int, ...] = (16, 16, 16)
    app_n_comp: Tuple[int, ...] = (48, 48, 48)
    app_dim: int = 27
    shading_mode: str = "MLP_Fea"                # MLP_PE | MLP_Fea | MLP | SH | RGB
    density_shift: float = -10.0
    alpha_mask_thres: float = 1e-3
    distance_scale: float = 25.0
    ray_march_weight_thres: float = 1e-4
    pos_pe: int = 6
    view_pe: int = 6
    fea_pe: int = 6
    featureC: int = 128
    step_ratio: float = 2.0
    fea2dense: str = "softplus"
    near_far: Tuple[float, float] = (2.0, 6.0)


class StageGeom(NamedTuple):
    """Host-side geometry of one training stage (update_stepSize,
    tensorBase.py:197-209)."""

    grid_size: Tuple[int, int, int]
    step_size: float
    n_samples: int
    units: Tuple[float, float, float]


def compute_stage_geom(cfg: TensoRFConfig, aabb, grid_size: Sequence[int],
                       n_samples_cap: int = 0) -> StageGeom:
    """Step size and samples per ray of a stage, in f64 on the host."""
    aabb = np.asarray(aabb, np.float64)
    size = aabb[1] - aabb[0]
    gs = np.asarray(grid_size, np.float64)
    units = size / (gs - 1)
    step = float(units.mean() * cfg.step_ratio)
    diag = float(np.sqrt((size**2).sum()))
    n = int(diag / step) + 1
    if n_samples_cap:
        n = min(n, n_samples_cap)
    return StageGeom(grid_size=tuple(int(g) for g in grid_size), step_size=step,
                     n_samples=n, units=tuple(float(u) for u in units))


# ---------------------------------------------------------------------------
# shading modules (tensorBase.py:62-136)
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """flax.linen.Dense: kernel [in, out] (lecun-normal, truncated at 2
    sigma), bias [out] (zeros)."""

    def __init__(self, n_in: int, n_out: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = math.sqrt(1.0 / n_in) / 0.87962566103423978
        kernel = torch.empty((n_in, n_out), device=device)
        nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel.t(), self.bias)


class DenseStack(nn.Module):
    """Dense layers named Dense_0, Dense_1, ... (flax's compact-call names)."""

    def __init__(self, widths: Sequence[Tuple[int, int]], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = len(widths)
        for i, (a, b) in enumerate(widths):
            self.add_module(f"Dense_{i}", Dense(a, b, device, generator))

    def layer(self, i: int) -> Dense:
        return getattr(self, f"Dense_{i}")


def tensorf_pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """TensoRF PE layout (tensorBase.py:9-15): [sin(all freqs x dims),
    cos(all)], not BARF's."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(x.shape[:-1] + (freqs * x.shape[-1],))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


class MLPRender(DenseStack):
    """The shared 3-layer shading MLP; its inputs vary by mode
    (tensorBase.py:62-136)."""

    def __init__(self, cfg: TensoRFConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        n_in = cfg.app_dim + 3
        if cfg.shading_mode == "MLP_Fea":
            n_in += 2 * cfg.fea_pe * cfg.app_dim + 2 * cfg.view_pe * 3
        elif cfg.shading_mode == "MLP_PE":
            n_in += 2 * cfg.pos_pe * 3 + 2 * cfg.view_pe * 3
        elif cfg.shading_mode == "MLP":
            n_in += 2 * cfg.view_pe * 3
        C = cfg.featureC
        super().__init__([(n_in, C), (C, C), (C, 3)], device, generator)
        self.mode, self.view_pe, self.fea_pe, self.pos_pe = (
            cfg.shading_mode, cfg.view_pe, cfg.fea_pe, cfg.pos_pe)

    def forward(self, pts, viewdirs, features):
        indata = [features, viewdirs]
        if self.mode == "MLP_Fea":
            if self.fea_pe > 0:
                indata.append(tensorf_pe(features, self.fea_pe))
            if self.view_pe > 0:
                indata.append(tensorf_pe(viewdirs, self.view_pe))
        elif self.mode == "MLP_PE":
            if self.pos_pe > 0:
                indata.append(tensorf_pe(pts, self.pos_pe))
            if self.view_pe > 0:
                indata.append(tensorf_pe(viewdirs, self.view_pe))
        elif self.mode == "MLP":
            if self.view_pe > 0:
                indata.append(tensorf_pe(viewdirs, self.view_pe))
        x = torch.cat(indata, dim=-1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return torch.sigmoid(self.Dense_2(x))


def sh_render(pts, viewdirs, features):
    """SH shading (tensorBase.py:27-31): features are degree-2 SH coefficients."""
    rgb_sh = features.reshape(features.shape[:-1] + (3, 9))
    return torch.relu(eval_sh(2, rgb_sh, viewdirs) + 0.5)


def shade(cfg: TensoRFConfig, params, pts, viewdirs, app_feat):
    """rgb of the appearance features by cfg.shading_mode."""
    if cfg.shading_mode.startswith("MLP"):
        return params["mlp"](pts, viewdirs, app_feat)
    if cfg.shading_mode == "SH":
        return sh_render(pts, viewdirs, app_feat)
    return app_feat  # RGB


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().requires_grad_(True)


def init_tensorf(cfg: TensoRFConfig, aabb, grid_size: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
    """(params, buffers) on ``device``: grids ~ N(0, scale) as init_one_svd
    (tensoRF.py:153-163, scale 0.1 VM, 0.2 CP), the basis matrix ~ U(-1/sqrt(in),
    1/sqrt(in)) (a bias-free Linear's default), the shading MLP (MLP modes)."""
    gs = [int(g) for g in grid_size]
    kw = dict(device=device, generator=generator)

    def normal(scale, *shape):
        return _leaf(scale * torch.randn(shape, **kw))

    params: Dict[str, Any] = {}
    if cfg.decomp == "vm_split":
        for name, comps in (("density", cfg.density_n_comp), ("app", cfg.app_n_comp)):
            params[f"{name}_plane"] = [normal(0.1, comps[i], gs[MAT_MODE[i][1]],
                                              gs[MAT_MODE[i][0]]) for i in range(3)]
            params[f"{name}_line"] = [normal(0.1, comps[i], gs[VEC_MODE[i]])
                                      for i in range(3)]
        n_basis_in = sum(cfg.app_n_comp)
    elif cfg.decomp == "cp":
        for name, comps in (("density", cfg.density_n_comp), ("app", cfg.app_n_comp)):
            params[f"{name}_line"] = [normal(0.2, comps[0], gs[VEC_MODE[i]]) for i in range(3)]
        n_basis_in = cfg.app_n_comp[0]
    elif cfg.decomp == "vm":
        # non-split TensorVM (tensoRF.py:4-31): one cubic res, density the
        # last D comps, appearance the first A
        D, A, res = cfg.density_n_comp[0], cfg.app_n_comp[0], gs[0]
        params["vm_plane"] = [normal(0.1, D + A, res, res) for _ in range(3)]
        params["vm_line"] = [normal(0.1, D + A, res) for _ in range(3)]
        n_basis_in = 3 * A
    else:
        raise ValueError(cfg.decomp)
    bound = 1.0 / np.sqrt(n_basis_in)
    params["basis_mat"] = _leaf(
        (torch.rand((n_basis_in, cfg.app_dim), **kw) * 2 - 1) * bound)
    if cfg.shading_mode.startswith("MLP"):
        params["mlp"] = MLPRender(cfg, device, generator)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    buffers = {"aabb": aabb_t, "alpha_volume": None, "alpha_aabb": aabb_t.clone(),
               "alpha_volume_dil": None}
    return params, buffers


def param_items(params) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """Every parameter with its path in the JAX tree, e.g. ("density_plane",
    "0"), ("mlp", "params", "Dense_0", "kernel"), ("normal_linear", "w")."""
    out = []
    for key in sorted(params):
        value = params[key]
        if isinstance(value, (list, tuple)):
            out += [((key, str(i)), t) for i, t in enumerate(value)]
        elif isinstance(value, nn.Module):
            prefix = (key,) if getattr(value, "flat", False) else (key, "params")
            out += [(prefix + tuple(name.split(".")), p)
                    for name, p in value.named_parameters()]
        else:
            out.append(((key,), value))
    return out


def param_groups(params) -> Tuple[List[Tuple[str, ...]], List[Tuple[str, ...]]]:
    """(paths of the spatial group, paths of the net group)."""
    items = param_items(params)
    return ([p for p, _ in items if p[0] not in NET_KEYS],
            [p for p, _ in items if p[0] in NET_KEYS])


def group_leaves(params) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(spatial tensors, net tensors) in param_groups order."""
    items = param_items(params)
    return ([t for p, t in items if p[0] not in NET_KEYS],
            [t for p, t in items if p[0] in NET_KEYS])


# ---------------------------------------------------------------------------
# factor evaluation
# ---------------------------------------------------------------------------


def _plane_line_cm(plane: torch.Tensor, line: torch.Tensor, xyz: torch.Tensor,
                   i: int) -> torch.Tensor:
    """plane_i(x_m0, x_m1) * line_i(x_vec) at xyz [M, 3] -> [C, M]."""
    m0, m1 = MAT_MODE[i]
    p = grid_sample_cm(plane, torch.stack([xyz[:, m0], xyz[:, m1]], dim=-1))
    return p * line_sample_cm(line, xyz[:, VEC_MODE[i]])


def compute_density_feature(cfg: TensoRFConfig, params, xyz: torch.Tensor) -> torch.Tensor:
    """Density factor feature at normalised coords xyz [M, 3] -> [M].

    VM: sum_i sum_c plane_i(x_m0, x_m1) line_i(x_vec) (tensoRF.py:209-225);
    CP: sum_c prod_i line_i(x_vec_i) (tensoRF.py:345-361)."""
    if cfg.decomp in ("vm_split", "vm"):
        total = 0.0
        for i in range(3):
            if cfg.decomp == "vm_split":
                plane, line = params["density_plane"][i], params["density_line"][i]
            else:
                D = cfg.density_n_comp[0]
                plane, line = params["vm_plane"][i][-D:], params["vm_line"][i][-D:]
            total = total + _plane_line_cm(plane, line, xyz, i).sum(0)
        return total
    lines = params["density_line"]
    prod = line_sample_cm(lines[0], xyz[:, VEC_MODE[0]])
    prod = prod * line_sample_cm(lines[1], xyz[:, VEC_MODE[1]])
    prod = prod * line_sample_cm(lines[2], xyz[:, VEC_MODE[2]])
    return prod.sum(0)


def app_factor_cm(cfg: TensoRFConfig, params, xyz: torch.Tensor) -> torch.Tensor:
    """The appearance factors before the basis matrix, [n_basis_in, M]."""
    if cfg.decomp in ("vm_split", "vm"):
        feats = []
        for i in range(3):
            if cfg.decomp == "vm_split":
                plane, line = params["app_plane"][i], params["app_line"][i]
            else:
                A = cfg.app_n_comp[0]
                plane, line = params["vm_plane"][i][:A], params["vm_line"][i][:A]
            feats.append(_plane_line_cm(plane, line, xyz, i))
        return torch.cat(feats, dim=0)
    lines = params["app_line"]
    feat = line_sample_cm(lines[0], xyz[:, VEC_MODE[0]])
    feat = feat * line_sample_cm(lines[1], xyz[:, VEC_MODE[1]])
    return feat * line_sample_cm(lines[2], xyz[:, VEC_MODE[2]])


def compute_app_feature(cfg: TensoRFConfig, params, xyz: torch.Tensor) -> torch.Tensor:
    """Appearance feature at xyz [M, 3] -> [M, app_dim] (tensoRF.py:228-244,
    364-379)."""
    return app_factor_cm(cfg, params, xyz).t() @ params["basis_mat"]


def feature2density(cfg: TensoRFConfig, f: torch.Tensor) -> torch.Tensor:
    """softplus(f + shift) | relu(f) (tensorBase.py:444-448)."""
    if cfg.fea2dense == "softplus":
        return F.softplus(f + cfg.density_shift)
    return torch.relu(f)


def normalize_coord(aabb: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """AABB -> [-1, 1] (tensorBase.py:224-225)."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


# ---------------------------------------------------------------------------
# ray sampling + alpha mask
# ---------------------------------------------------------------------------


def sample_ray(aabb: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
               step_size: float, n_samples: int, near_far: Tuple[float, float],
               jitter: Optional[torch.Tensor] = None):
    """AABB-clipped fixed-step sampling (tensorBase.py:340-360); ``jitter``
    [N, 1] in [0, 1) shifts each ray's samples. Returns (pts [N, S, 3],
    z_vals [N, S], valid [N, S])."""
    near, far = near_far
    vec = torch.where(rays_d == 0, 1e-6, rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    rng = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device)[None, :]
    if jitter is not None:
        rng = rng + jitter
    z_vals = t_min[:, None] + step_size * rng
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    out = torch.logical_or(aabb[0] > pts, pts > aabb[1]).any(-1)
    return pts, z_vals, torch.logical_not(out)


def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in f32: start * (1 - s) + stop * s at
    s = i * f32(1 / (num - 1)) (XLA's reciprocal of the division), the last
    element ``stop``; element for element the JAX values for (0, 1)."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    recip = float(np.float32(1.0) / np.float32(num - 1))
    s = torch.arange(num - 1, dtype=torch.float32, device=device) * recip
    head = start * (1 - s) + stop * s
    return torch.cat([head, torch.full((1,), stop, dtype=torch.float32, device=device)])


def sample_ray_ndc(aabb: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                   n_samples: int, near_far: Tuple[float, float],
                   jitter: Optional[torch.Tensor] = None):
    """Uniform near-far sampling for NDC rays (tensorBase.py:328-338);
    ``jitter`` [N, S] in [0, 1)."""
    near, far = near_far
    z_vals = linspace_f32(near, far, n_samples, rays_o.device)[None].expand(
        rays_o.shape[0], n_samples)
    if jitter is not None:
        z_vals = z_vals + jitter * ((far - near) / n_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    out = torch.logical_or(aabb[0] > pts, pts > aabb[1]).any(-1)
    return pts, z_vals, torch.logical_not(out)


def sample_alpha_mask(alpha_volume: torch.Tensor, alpha_aabb: torch.Tensor,
                      xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear alpha-mask lookup (AlphaGridMask, tensorBase.py:39-59); the
    volume is [D, H, W], indexed (z, y, x)."""
    return grid_sample_3d(alpha_volume[None], normalize_coord(alpha_aabb, xyz))[..., 0]


def dilate_alpha_corners(vol: torch.Tensor) -> torch.Tensor:
    """Max over each trilinear cell's corner window: dil[i] = max vol[i:i+2]
    per axis, the border clamped like the corner index. For a binary volume
    ``dil[cell_base] > 0`` is ``trilinear(vol) > 0`` inside a cell, and a
    one-voxel superset of it on the clamped border and at grid planes."""
    for ax in range(3):
        n = vol.shape[ax]
        if n > 1:
            idx = torch.clamp_max(torch.arange(n, device=vol.device) + 1, n - 1)
            vol = torch.maximum(vol, vol.index_select(ax, idx))
    return vol


def prepare_alpha_buffers(buffers):
    """The corner-dilated alpha volume, derived once per stage (after the
    mask is installed or restored)."""
    buffers = dict(buffers)
    vol = buffers.get("alpha_volume")
    buffers["alpha_volume_dil"] = None if vol is None else dilate_alpha_corners(vol)
    return buffers


def alpha_mask_valid(buffers, xyz: torch.Tensor) -> Optional[torch.Tensor]:
    """Boolean occupancy gate of the installed alpha mask (None without one):
    one lookup in the dilated volume when it exists, else the trilinear
    lookup > 0."""
    if buffers.get("alpha_volume") is None:
        return None
    dil = buffers.get("alpha_volume_dil")
    if dil is not None:
        coords = normalize_coord(buffers["alpha_aabb"], xyz)
        D, H, W = dil.shape
        x0 = cell_base_index(coords[..., 0], W)
        y0 = cell_base_index(coords[..., 1], H)
        z0 = cell_base_index(coords[..., 2], D)
        return dil.reshape(-1)[(z0 * H + y0) * W + x0] > 0
    return sample_alpha_mask(buffers["alpha_volume"], buffers["alpha_aabb"], xyz) > 0


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


class TensoRFOut(NamedTuple):
    rgb_map: torch.Tensor
    depth_map: torch.Tensor
    weight: torch.Tensor
    sigma: torch.Tensor
    bg_weight: torch.Tensor
    z_vals: torch.Tensor
    extras: Dict[str, torch.Tensor]


def selected(mask: torch.Tensor) -> torch.Tensor:
    """Flat indices of the True entries of ``mask`` (one host sync on a
    CUDA tensor: the count sets the shape)."""
    return mask.reshape(-1).nonzero().squeeze(1)


def scatter_rows(idx: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...] zeros with ``rows`` at ``idx`` (differentiable in rows)."""
    out = rows.new_zeros((n,) + rows.shape[1:])
    return out.index_copy(0, idx, rows)


def masked_density(cfg: TensoRFConfig, params, valid: torch.Tensor,
                   xyz: torch.Tensor) -> torch.Tensor:
    """sigma [N, S]: feature2density of the density feature where ``valid``,
    0 elsewhere; the factors are evaluated only at the valid samples."""
    idx = selected(valid)
    sig = feature2density(cfg, compute_density_feature(cfg, params, xyz.reshape(-1, 3)[idx]))
    return scatter_rows(idx, sig, valid.numel()).reshape(valid.shape)


def composite_maps(cfg: TensoRFConfig, weight, rgb_s, z_vals, rays, white_bg: bool):
    """(rgb_map, depth_map): the weighted sums, white background, the clip to
    [0, 1], and the leftover transmittance's depth at the far plane."""
    acc_map = weight.sum(-1)
    rgb_map = (weight[..., None] * rgb_s).sum(-2)
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    rgb_map = torch.clamp(rgb_map, 0.0, 1.0)
    depth_map = (weight * z_vals).sum(-1)
    far_plane = (rays[:, -1] if rays.shape[-1] > 6
                 else torch.full_like(acc_map, cfg.near_far[1]))
    return rgb_map, depth_map + (1.0 - acc_map) * far_plane


def tensorf_forward(cfg: TensoRFConfig, geom: StageGeom, params, buffers,
                    rays: torch.Tensor, jitter: Optional[torch.Tensor] = None,
                    white_bg: bool = True, n_samples: Optional[int] = None,
                    ndc_ray: bool = False) -> TensoRFOut:
    """The TensoRF forward on rays [N, 6(+1 far)] (tensorBase.py:476-536);
    ``jitter`` None renders at the unjittered samples (eval)."""
    n_s = n_samples or geom.n_samples
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    aabb = buffers["aabb"]
    with span("tensorf.sample"):
        if ndc_ray:
            pts, z_vals, valid = sample_ray_ndc(aabb, rays_o, viewdirs, n_s, cfg.near_far,
                                                jitter)
        else:
            pts, z_vals, valid = sample_ray(aabb, rays_o, viewdirs, geom.step_size, n_s,
                                            cfg.near_far, jitter)
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           torch.zeros_like(z_vals[:, :1])], -1)
        if ndc_ray:
            norm = torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
            dists = dists * norm
            viewdirs = viewdirs / norm
        occ = alpha_mask_valid(buffers, pts)
        if occ is not None:
            valid = torch.logical_and(valid, occ)
        xyz = normalize_coord(aabb, pts)
    with span("tensorf.density"):
        sigma = masked_density(cfg, params, valid, xyz)
    with span("tensorf.shade"):
        alpha, weight, bg_weight = raw2alpha(sigma, dists * cfg.distance_scale)
        app_mask = weight > cfg.ray_march_weight_thres

        idx = selected(app_mask)
        xyz_a = xyz.reshape(-1, 3)[idx]
        dirs = viewdirs[torch.div(idx, n_s, rounding_mode="floor")]
        rgb = shade(cfg, params, xyz_a, dirs, compute_app_feature(cfg, params, xyz_a))
        rgb_s = scatter_rows(idx, rgb, app_mask.numel()).reshape(app_mask.shape + (3,))
    with span("tensorf.composite"):
        rgb_map, depth_map = composite_maps(cfg, weight, rgb_s, z_vals, rays, white_bg)
    return TensoRFOut(rgb_map=rgb_map, depth_map=depth_map, weight=weight, sigma=sigma,
                      bg_weight=bg_weight, z_vals=z_vals,
                      extras={"app_mask": app_mask, "valid": valid})


def compute_alpha(cfg: TensoRFConfig, params, buffers, xyz: torch.Tensor,
                  length: float) -> torch.Tensor:
    """Opacity of a dense point set xyz [M, 3] (tensorBase.py:450-473)."""
    occ = alpha_mask_valid(buffers, xyz)
    feat = compute_density_feature(cfg, params, normalize_coord(buffers["aabb"], xyz))
    sigma = feature2density(cfg, feat)
    if occ is not None:
        sigma = torch.where(occ, sigma, 0.0)
    return 1.0 - torch.exp(-sigma * length)


# ---------------------------------------------------------------------------
# stage transforms: alpha-mask update, upsample, shrink
# ---------------------------------------------------------------------------

DENSE_CHUNK = 1 << 21  # points per compute_alpha call of get_dense_alpha


@torch.no_grad()
def get_dense_alpha(cfg: TensoRFConfig, geom: StageGeom, params, buffers,
                    grid_size: Optional[Sequence[int]] = None):
    """Dense alpha grid [gx, gy, gz] and its sample coords [gx, gy, gz, 3]
    (tensorBase.py:366-383)."""
    gs = tuple(int(g) for g in (grid_size or geom.grid_size))
    device = buffers["aabb"].device
    lin = [linspace_f32(0.0, 1.0, g, device) for g in gs]
    s = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)
    aabb = buffers["aabb"]
    dense_xyz = aabb[0] * (1 - s) + aabb[1] * s
    per = max(1, DENSE_CHUNK // (gs[1] * gs[2]))
    alpha = torch.cat([
        compute_alpha(cfg, params, buffers, dense_xyz[a:a + per].reshape(-1, 3),
                      geom.step_size).reshape(-1, gs[1], gs[2])
        for a in range(0, gs[0], per)])
    return alpha, dense_xyz


@torch.no_grad()
def update_alpha_mask(cfg: TensoRFConfig, geom: StageGeom, params, buffers,
                      grid_size=(200, 200, 200)):
    """-> (buffers with the binary alpha volume [gz, gy, gx], the tight AABB
    of its occupied voxels as numpy [2, 3]) (tensorBase.py:385-409)."""
    alpha, dense_xyz = get_dense_alpha(cfg, geom, params, buffers, grid_size)
    alpha = torch.clamp(alpha, 0, 1)
    alpha_t = alpha.permute(2, 1, 0).contiguous()  # [gz, gy, gx]
    alpha_t = F.max_pool3d(alpha_t[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    alpha_bin = (alpha_t >= cfg.alpha_mask_thres).to(torch.float32)

    valid = alpha_bin.permute(2, 1, 0) > 0.5  # back to (x, y, z)
    big = 1e10
    xyz_min = torch.where(valid[..., None], dense_xyz, big).amin(dim=(0, 1, 2))
    xyz_max = torch.where(valid[..., None], dense_xyz, -big).amax(dim=(0, 1, 2))
    new_buffers = dict(buffers)
    new_buffers["alpha_volume"] = alpha_bin
    new_buffers["alpha_aabb"] = buffers["aabb"]
    return prepare_alpha_buffers(new_buffers), torch.stack([xyz_min, xyz_max]).cpu().numpy()


def _resize(grid: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [C, H, W] with align_corners=True."""
    return F.interpolate(grid[None], size=tuple(hw), mode="bilinear", align_corners=True)[0]


@torch.no_grad()
def upsample_volume_grid(cfg: TensoRFConfig, params, res_target: Sequence[int]):
    """Bilinear upsample of every factor to ``res_target`` (tensoRF.py:248-271):
    new params (the modules shared)."""
    res = [int(r) for r in res_target]

    def planes(ps):
        return [_leaf(_resize(p, (res[MAT_MODE[i][1]], res[MAT_MODE[i][0]])))
                for i, p in enumerate(ps)]

    def lines(ls):
        return [_leaf(_resize(v[:, :, None], (res[VEC_MODE[i]], 1))[:, :, 0])
                for i, v in enumerate(ls)]

    new = dict(params)
    for key in params:
        if key.endswith("_plane"):
            new[key] = planes(params[key])
        elif key.endswith("_line"):
            new[key] = lines(params[key])
    return new


@torch.no_grad()
def shrink(cfg: TensoRFConfig, geom: StageGeom, params, buffers, new_aabb):
    """Slice the factor grids to a tightened AABB (tensoRF.py:273-314), on the
    host's numpy index arithmetic. Returns (params, buffers, new grid size)."""
    aabb = buffers["aabb"].cpu().numpy()
    units = np.asarray(geom.units)
    gs = np.asarray(geom.grid_size)
    xyz_min, xyz_max = np.asarray(new_aabb)
    t_l = np.round((xyz_min - aabb[0]) / units).astype(int)
    b_r = np.round((xyz_max - aabb[0]) / units).astype(int) + 1
    b_r = np.minimum(b_r, gs)
    new = dict(params)
    for key in params:
        if key.endswith("_line"):
            new[key] = [_leaf(v[:, t_l[VEC_MODE[i]]:b_r[VEC_MODE[i]]])
                        for i, v in enumerate(params[key])]
        elif key.endswith("_plane"):
            new[key] = [_leaf(p[:, t_l[MAT_MODE[i][1]]:b_r[MAT_MODE[i][1]],
                                t_l[MAT_MODE[i][0]]:b_r[MAT_MODE[i][0]]])
                        for i, p in enumerate(params[key])]
    # snap the aabb to the voxel lattice when the alpha grid's resolution is
    # not the model's (tensoRF.py:297-305)
    vol = buffers.get("alpha_volume")
    alpha_gs = None if vol is None else tuple(vol.shape[::-1])
    if alpha_gs is not None and alpha_gs != tuple(geom.grid_size):
        t_l_r = t_l / (gs - 1)
        b_r_r = (b_r - 1) / (gs - 1)
        new_aabb = np.stack([(1 - t_l_r) * aabb[0] + t_l_r * aabb[1],
                             (1 - b_r_r) * aabb[0] + b_r_r * aabb[1]])
    new_buffers = dict(buffers)
    new_buffers["aabb"] = torch.as_tensor(np.asarray(new_aabb, np.float32),
                                          device=buffers["aabb"].device)
    return new, new_buffers, tuple(int(x) for x in (b_r - t_l))


# ---------------------------------------------------------------------------
# regularisers (tensoRF.py:177-207)
# ---------------------------------------------------------------------------


def vector_comp_diffs(params) -> torch.Tensor:
    """Mean |off-diagonal| of the line factors' Gram matrices (tensoRF.py:177-189)."""
    lines = (list(params["vm_line"]) if "vm_line" in params
             else list(params["density_line"]) + list(params["app_line"]))
    total = 0.0
    for v in lines:
        n_comp = v.shape[0]
        dotp = v @ v.t()
        off = dotp - torch.diag(torch.diag(dotp))
        total = total + torch.abs(off).sum() / (n_comp * (n_comp - 1))
    return total


def density_L1(cfg: TensoRFConfig, params) -> torch.Tensor:
    """Mean |density factor| (tensoRF.py:191-195; VM: planes and lines, CP: lines)."""
    total = 0.0
    for i in range(3):
        if cfg.decomp == "vm_split":
            total = total + torch.abs(params["density_plane"][i]).mean() \
                + torch.abs(params["density_line"][i]).mean()
        elif cfg.decomp == "vm":
            D = cfg.density_n_comp[0]
            total = total + torch.abs(params["vm_plane"][i][-D:]).mean() \
                + torch.abs(params["vm_line"][i][-D:]).mean()
        else:
            total = total + torch.abs(params["density_line"][i]).mean()
    return total


def tv_loss_2d(grid: torch.Tensor) -> torch.Tensor:
    """TVLoss on [C, H, W] (tensorf utils.py:123-142)."""
    h_tv = ((grid[:, 1:, :] - grid[:, :-1, :]) ** 2).sum()
    w_tv = ((grid[:, :, 1:] - grid[:, :, :-1]) ** 2).sum()
    C, H, W = grid.shape
    return 2 * (h_tv / (C * (H - 1) * W) + w_tv / (C * H * (W - 1)))


def _tv(cfg: TensoRFConfig, params, name: str, sl) -> torch.Tensor:
    total = 0.0
    if cfg.decomp == "vm_split":
        for p in params[f"{name}_plane"]:
            total = total + tv_loss_2d(p) * 1e-2
    elif cfg.decomp == "vm":
        for p in params["vm_plane"]:
            total = total + tv_loss_2d(p[sl]) * 1e-2
    else:
        for v in params[f"{name}_line"]:
            total = total + tv_loss_2d(v[:, :, None]) * 1e-3
    return total


def tv_loss_density(cfg: TensoRFConfig, params) -> torch.Tensor:
    """tensoRF.py:197-201 (planes x 1e-2 for VM, lines x 1e-3 for CP)."""
    return _tv(cfg, params, "density", slice(-cfg.density_n_comp[0], None))


def tv_loss_app(cfg: TensoRFConfig, params) -> torch.Tensor:
    """tensoRF.py:203-207."""
    return _tv(cfg, params, "app", slice(None, cfg.app_n_comp[0]))


def filter_rays_bbox(aabb: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the rays that hit the AABB (filtering_rays bbox_only,
    tensorBase.py:411-431)."""
    rays_o, rays_d = rays[..., :3], rays[..., 3:6]
    vec = torch.where(rays_d == 0, 1e-6, rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(-1)
    t_max = torch.maximum(rate_a, rate_b).amin(-1)
    return t_max > t_min
