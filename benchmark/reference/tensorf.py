"""Plain PyTorch reference of TensoRF (TensorVMSplit, MLP_Fea shading)
training at a fixed stage, as the TensoRF fork's Coffee configuration runs
it past its last event.

It imports only torch and numpy. Written out here: the AABB-clipped
fixed-step sampling with its jitter, the alpha mask (a dense alpha grid of
the density field, a 3^3 max-pool, the threshold, the corner dilation) and
its gate, the vector-matrix factors sampled bilinearly (planes) and
linearly (lines) with align-corners, border-clamped coordinates, the
softplus density, the alpha compositing with its transmittance product,
the appearance basis and the MLP_Fea shader with its positional encodings,
the white background, the MSE with the L1 and TV regularisers, and the two
Adams (factor grids and the basis and MLP) with their decayed learning
rates.

Precision: f32 with TF32 off (``tf32=False``); the control is the same
arithmetic with TF32 matrix products (``tf32=True``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
BETAS, EPS = (0.9, 0.99), 1e-8


@dataclasses.dataclass(frozen=True)
class TensoRFSpec:
    """What the reference needs of a TensoRF configuration (tensorf_spec)."""

    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    grid: Tuple[int, int, int]
    step_size: float
    n_samples: int
    density_comp: Tuple[int, int, int] = (16, 16, 16)
    app_comp: Tuple[int, int, int] = (48, 48, 48)
    app_dim: int = 27
    feature_c: int = 128
    view_pe: int = 2
    fea_pe: int = 2
    density_shift: float = -10.0
    distance_scale: float = 25.0
    weight_thres: float = 1e-3
    alpha_thres: float = 1e-3
    near_far: Tuple[float, float] = (0.5, 6.0)
    batch: int = 4096
    lr_init: float = 0.02
    lr_basis: float = 1e-3
    lr_factor: float = 0.1 ** (1.0 / 30000)
    l1_weight: float = 2e-5
    tv_density: float = 0.3
    tv_app: float = 0.3
    mask_reso_cap: int = 256


def tensorf_spec(cfg: dict) -> TensoRFSpec:
    """TensoRFSpec from a configuration file's ``tensorf`` section (the
    keys of tensorf-myc's configs/*.txt) at the stage its voxel count gives,
    with the TensoRF CLI's defaults (step_ratio 0.5)."""
    a = cfg["tensorf"]
    aabb = np.asarray(a["bbox"], np.float64).reshape(2, 3)
    size = aabb[1] - aabb[0]
    voxel = (size.prod() / cfg["stage"]["n_voxels"]) ** (1.0 / 3)
    grid = [int(x) for x in size / voxel]
    units = size / (np.asarray(grid, np.float64) - 1)
    step = float(units.mean() * a.get("step_ratio", 0.5))
    n = min(int(float(np.sqrt((size ** 2).sum())) / step) + 1, a.get("nSamples", 1_000_000))
    n_iters = a.get("n_iters", 30000)
    iters = a.get("lr_decay_iters", -1)
    return TensoRFSpec(
        aabb=(tuple(float(v) for v in aabb[0]), tuple(float(v) for v in aabb[1])),
        grid=tuple(grid), step_size=step, n_samples=n,
        density_comp=tuple(a["n_lamb_sigma"]), app_comp=tuple(a["n_lamb_sh"]),
        app_dim=a.get("data_dim_color", 27), feature_c=a.get("featureC", 128),
        view_pe=a.get("view_pe", 6), fea_pe=a.get("fea_pe", 6),
        density_shift=a.get("density_shift", -10.0),
        distance_scale=a.get("distance_scale", 25.0),
        weight_thres=a.get("rm_weight_mask_thre", 1e-4),
        alpha_thres=a.get("alpha_mask_thre", 1e-3),
        near_far=(a.get("near", 2.0), a.get("far", 6.0)), batch=a.get("batch_size", 4096),
        lr_init=a.get("lr_init", 0.02), lr_basis=a.get("lr_basis", 1e-3),
        lr_factor=a.get("lr_decay_target_ratio", 0.1) ** (1.0 / (iters if iters > 0 else n_iters)),
        l1_weight=a.get("L1_weight_rest", 0.0), tv_density=a.get("TV_weight_density", 0.0),
        tv_app=a.get("TV_weight_app", 0.0))


# ---------------------------------------------------------------------------
# parameters, in the trainer's leaf order
# ---------------------------------------------------------------------------


def plane_shape(spec: TensoRFSpec, i: int, comps: int) -> Tuple[int, int, int]:
    m0, m1 = MAT_MODE[i]
    return (comps, spec.grid[m1], spec.grid[m0])


def mlp_in(spec: TensoRFSpec) -> int:
    return spec.app_dim + 3 + 2 * spec.fea_pe * spec.app_dim + 2 * spec.view_pe * 3


def leaf_shapes(spec: TensoRFSpec) -> Dict[str, Tuple[int, ...]]:
    """Every parameter, spatial group first (app lines, app planes, density
    lines, density planes), then the net group (basis, MLP kernels and
    biases), as the trainer orders them."""
    out: Dict[str, Tuple[int, ...]] = {}
    for name, comps in (("app", spec.app_comp), ("density", spec.density_comp)):
        for i in range(3):
            out[f"{name}_line.{i}"] = (comps[i], spec.grid[VEC_MODE[i]])
        for i in range(3):
            out[f"{name}_plane.{i}"] = plane_shape(spec, i, comps[i])
    C = spec.feature_c
    out["basis_mat"] = (sum(spec.app_comp), spec.app_dim)
    for k, (a, b) in enumerate(((mlp_in(spec), C), (C, C), (C, 3))):
        out[f"mlp.Dense_{k}.kernel"] = (a, b)
        out[f"mlp.Dense_{k}.bias"] = (b,)
    return out


SPATIAL = ("app_line", "app_plane", "density_line", "density_plane")


def is_spatial(name: str) -> bool:
    return name.split(".")[0] in SPATIAL


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------


def bilinear(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """plane [C, H, W] at (x, y) in [-1, 1] (x along W), align-corners,
    border-clamped -> [C, M]."""
    C, H, W = plane.shape
    ix = torch.clamp((x + 1.0) * 0.5 * (W - 1), 0.0, W - 1.0)
    iy = torch.clamp((y + 1.0) * 0.5 * (H - 1), 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(ix), max=max(W - 2, 0))
    y0 = torch.clamp(torch.floor(iy), max=max(H - 2, 0))
    fx, fy = ix - x0, iy - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    flat = plane.reshape(C, -1)
    return (flat[:, y0 * W + x0] * ((1 - fx) * (1 - fy)) + flat[:, y0 * W + x1] * (fx * (1 - fy))
            + flat[:, y1 * W + x0] * ((1 - fx) * fy) + flat[:, y1 * W + x1] * (fx * fy))


def linear(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """line [C, L] at t in [-1, 1], align-corners, border-clamped -> [C, M]."""
    L = line.shape[1]
    it = torch.clamp((t + 1.0) * 0.5 * (L - 1), 0.0, L - 1.0)
    t0 = torch.clamp(torch.floor(it), max=max(L - 2, 0))
    f = it - t0
    t0 = t0.to(torch.int64)
    t1 = torch.clamp(t0 + 1, max=L - 1)
    return line[:, t0] * (1 - f) + line[:, t1] * f


def factors(p: Dict[str, torch.Tensor], name: str, xyz: torch.Tensor) -> List[torch.Tensor]:
    """plane_i * line_i at normalised xyz [M, 3], one [C, M] per i."""
    out = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        out.append(bilinear(p[f"{name}_plane.{i}"], xyz[:, m0], xyz[:, m1])
                   * linear(p[f"{name}_line.{i}"], xyz[:, VEC_MODE[i]]))
    return out


def density(spec: TensoRFSpec, p, xyz: torch.Tensor) -> torch.Tensor:
    f = sum(c.sum(0) for c in factors(p, "density", xyz))
    return torch.nn.functional.softplus(f + spec.density_shift)


def pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(x.shape[:-1] + (freqs * x.shape[-1],))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def shade(spec: TensoRFSpec, p, xyz: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    feat = torch.cat(factors(p, "app", xyz), 0).t() @ p["basis_mat"]
    x = torch.cat([feat, dirs, pe(feat, spec.fea_pe), pe(dirs, spec.view_pe)], -1)
    for k in range(3):
        x = x @ p[f"mlp.Dense_{k}.kernel"] + p[f"mlp.Dense_{k}.bias"]
        x = torch.relu(x) if k < 2 else torch.sigmoid(x)
    return x


def normalize(aabb: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


# ---------------------------------------------------------------------------
# alpha mask
# ---------------------------------------------------------------------------


def linspace01(n: int, device) -> torch.Tensor:
    s = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    return torch.cat([s, torch.ones(1, device=device)])


@torch.no_grad()
def alpha_mask(spec: TensoRFSpec, p, aabb: torch.Tensor) -> torch.Tensor:
    """The corner-dilated binary alpha volume [gz, gy, gx] of the density
    field, on the grid min(stage grid, cap) per axis."""
    gs = [min(g, spec.mask_reso_cap) for g in spec.grid]
    dev = aabb.device
    lin = [linspace01(g, dev) for g in gs]
    s = torch.stack(torch.meshgrid(*lin, indexing="ij"), -1)
    xyz = aabb[0] * (1 - s) + aabb[1] * s
    per = max(1, (1 << 21) // (gs[1] * gs[2]))
    alpha = torch.cat([
        (1.0 - torch.exp(-density(spec, p, normalize(aabb, xyz[a:a + per].reshape(-1, 3)))
                         * spec.step_size)).reshape(-1, gs[1], gs[2])
        for a in range(0, gs[0], per)])
    vol = torch.clamp(alpha, 0, 1).permute(2, 1, 0).contiguous()
    vol = torch.nn.functional.max_pool3d(vol[None, None], 3, 1, 1)[0, 0]
    vol = (vol >= spec.alpha_thres).to(torch.float32)
    for ax in range(3):
        n = vol.shape[ax]
        if n > 1:
            idx = torch.clamp_max(torch.arange(n, device=dev) + 1, n - 1)
            vol = torch.maximum(vol, vol.index_select(ax, idx))
    return vol


def cell_base(coord: torch.Tensor, size: int) -> torch.Tensor:
    c = (coord + 1.0) * 0.5 * (size - 1)
    return torch.clamp(torch.floor(c).to(torch.int64), 0, size - 2)


def gate(vol: torch.Tensor, aabb: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    c = normalize(aabb, pts)
    D, H, W = vol.shape
    idx = (cell_base(c[..., 2], D) * H + cell_base(c[..., 1], H)) * W + cell_base(c[..., 0], W)
    return vol.reshape(-1)[idx] > 0


# ---------------------------------------------------------------------------
# forward, loss, optimizer
# ---------------------------------------------------------------------------


class Forward(NamedTuple):
    rgb: torch.Tensor        # [N, 3]
    valid: torch.Tensor      # [N, S] gated samples
    shaded: torch.Tensor     # [N, S] samples shaded


def forward(spec: TensoRFSpec, p, vol: torch.Tensor, aabb: torch.Tensor, rays: torch.Tensor,
            jitter: torch.Tensor) -> Forward:
    o, d = rays[:, :3], rays[:, 3:6]
    S = spec.n_samples
    near, far = spec.near_far
    vec = torch.where(d == 0, 1e-6, d)
    t_min = torch.clamp(torch.minimum((aabb[1] - o) / vec, (aabb[0] - o) / vec).amax(-1),
                        near, far)
    z = t_min[:, None] + spec.step_size * (torch.arange(S, dtype=torch.float32,
                                                        device=o.device)[None, :] + jitter)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    valid = ~torch.logical_or(aabb[0] > pts, pts > aabb[1]).any(-1)
    valid = valid & gate(vol, aabb, pts)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
    xyz = normalize(aabb, pts).reshape(-1, 3)
    idx = valid.reshape(-1).nonzero().squeeze(1)
    sigma = torch.zeros(valid.numel(), device=o.device).index_put(
        (idx,), density(spec, p, xyz[idx])).reshape(valid.shape)
    alpha = 1.0 - torch.exp(-sigma * dists * spec.distance_scale)
    T = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
    w = alpha * T[:, :-1]
    shaded = w > spec.weight_thres
    ia = shaded.reshape(-1).nonzero().squeeze(1)
    rgb_a = shade(spec, p, xyz[ia], d[torch.div(ia, S, rounding_mode="floor")])
    rgb_s = torch.zeros((valid.numel(), 3), device=o.device).index_put((ia,), rgb_a)
    rgb = (w[..., None] * rgb_s.reshape(*valid.shape, 3)).sum(-2) + (1.0 - w.sum(-1))[:, None]
    return Forward(torch.clamp(rgb, 0.0, 1.0), valid, shaded)


def tv2d(g: torch.Tensor) -> torch.Tensor:
    C, H, W = g.shape
    h = ((g[:, 1:, :] - g[:, :-1, :]) ** 2).sum()
    w = ((g[:, :, 1:] - g[:, :, :-1]) ** 2).sum()
    return 2 * (h / (C * (H - 1) * W) + w / (C * H * (W - 1)))


def loss(spec: TensoRFSpec, p, fwd: Forward, target: torch.Tensor, step: int) -> torch.Tensor:
    """MSE + L1 of the density factors + TV of the planes (x 1e-2), the TV
    weights decayed by lr_factor^(step + 1)."""
    total = torch.mean((fwd.rgb - target) ** 2)
    total = total + spec.l1_weight * sum(
        torch.abs(p[f"density_plane.{i}"]).mean() + torch.abs(p[f"density_line.{i}"]).mean()
        for i in range(3))
    decay = spec.lr_factor ** (step + 1)
    total = total + spec.tv_density * decay * sum(
        tv2d(p[f"density_plane.{i}"]) * 1e-2 for i in range(3))
    total = total + spec.tv_app * decay * sum(tv2d(p[f"app_plane.{i}"]) * 1e-2 for i in range(3))
    return total


class Adam:
    """Adam with eps outside the root; lr = base * factor^count at the count
    before the increment."""

    def __init__(self, params: Sequence[torch.Tensor], base: float, factor: float):
        self.base, self.factor, self.count = base, factor, 0
        self.mu = [torch.zeros_like(t) for t in params]
        self.nu = [torch.zeros_like(t) for t in params]

    @torch.no_grad()
    def step(self, params, grads) -> None:
        b1, b2 = BETAS
        lr = self.base * self.factor ** self.count
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for t, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            t.add_(-lr * (m / c1) / (torch.sqrt(v / c2) + EPS))


class TrainTrace(NamedTuple):
    losses: List[float]
    grad_norms: List[float]
    change_norms: List[float]


def train_steps(spec: TensoRFSpec, init: Dict[str, torch.Tensor], batches, first_step: int,
                tf32: bool = False) -> TrainTrace:
    """The alpha mask of the initial field, then one step per batch (rays
    [N, 6], target [N, 3], jitter [N, 1]) from global step ``first_step``.
    Returns each step's loss, the per-leaf norms of the first gradient and
    of the change over the steps, leaves in leaf_shapes order."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        names = list(leaf_shapes(spec))
        p = {n: init[n].detach().float().clone().requires_grad_(True) for n in names}
        dev = p[names[0]].device
        aabb = torch.tensor(spec.aabb, dtype=torch.float32, device=dev)
        vol = alpha_mask(spec, p, aabb)
        spatial = [n for n in names if is_spatial(n)]
        net = [n for n in names if not is_spatial(n)]
        opts = (Adam([p[n] for n in spatial], spec.lr_init, spec.lr_factor),
                Adam([p[n] for n in net], spec.lr_basis, spec.lr_factor))
        losses, grad_norms = [], []
        for s, (rays, target, jitter) in enumerate(batches):
            fwd = forward(spec, p, vol, aabb, rays, jitter)
            total = loss(spec, p, fwd, target, first_step + s)
            grads = dict(zip(names, torch.autograd.grad(total, [p[n] for n in names],
                                                        allow_unused=True)))
            grads = {n: torch.zeros_like(p[n]) if g is None else g for n, g in grads.items()}
            if s == 0:
                grad_norms = [float(torch.linalg.norm(grads[n])) for n in spatial + net]
            opts[0].step([p[n] for n in spatial], [grads[n] for n in spatial])
            opts[1].step([p[n] for n in net], [grads[n] for n in net])
            losses.append(float(total.detach()))
        change = [float(torch.linalg.norm(p[n].detach() - init[n].float()))
                  for n in spatial + net]
        return TrainTrace(losses, grad_norms, change)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

