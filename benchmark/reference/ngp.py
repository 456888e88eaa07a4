"""Plain PyTorch reference of Instant-NGP training and rendering, as the
Car configuration runs them (the JNeRF fork's ngp_base.py and Car.py).

It imports only torch and numpy. Every step is written out with plain
tensor operations: the cascaded occupancy grid and its update, the fused
occupancy march, the brick3 grid encode (the brick addressing and the
level groups of the layout the tables are stored in), the spherical
harmonics of the view direction, the two bias-free MLPs, the NGP
compositor, the Huber loss, Adam with the fp16 gradient emulation, and the
EMA blended into the live parameters.

Precision: ``quant`` names the rounding applied where the configuration
computes in bf16 (the encode's output, the MLPs' inputs, weights and
hidden activations). "f32" (the reference) rounds nothing; "fp8" (the
control) rounds each of those tensors to float8 e4m3 with a per-tensor
scale, and passes gradients through unchanged. Matrix products run in
f32 with TF32 off (``no_tf32``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

SQRT3 = 1.73205080757
MAX_STEP = 1024
GRID = 128
N_CASCADES = 5
MIN_OPTICAL_THICKNESS = 0.01
PROBE_STRIDE = 19349663
PROBE_OFFSET = 96925573
N_PROBES = 10
HASH_PRIMES = (1, 19349663, 83492791)
U32 = 0xFFFFFFFF
BRICK_CELLS, BRICK_VERTS, ROW_VERTS = 4, 5, 128


@contextlib.contextmanager
def no_tf32():
    """f32 matrix products in f32: TF32 off for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def quantize(x: torch.Tensor, quant: str) -> torch.Tensor:
    """x rounded as ``quant`` says, in f32; gradients pass straight through."""
    if quant == "f32":
        return x
    if quant == "bf16":
        q = x.detach().to(torch.bfloat16).float()
    elif quant == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(f"unknown precision {quant!r}")
    return x + (q - x).detach()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NGPSpec:
    """The sizes and settings the reference needs, read from the
    configuration file's run_net section (ngp_spec)."""

    aabb_scale: int
    n_levels: int = 16
    n_features: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: float = 2048.0
    density_hidden: int = 64
    rgb_hidden: int = 64
    geo_feat: int = 16
    n_coarse: int = 512
    n_samples: int = 64
    n_compact: int = 64
    near_distance: float = 0.2
    early_stop_eps: float = 1e-4
    lr: float = 0.1
    eps: float = 1e-15
    betas: Tuple[float, float] = (0.9, 0.99)
    ema_decay: float = 0.95
    decay_start: int = 20000
    decay_interval: int = 10000
    decay_base: float = 0.33
    huber_delta: float = 0.1
    n_grid_uniform: int = 1 << 16
    n_grid_nonuniform: int = 1 << 16
    fp16_grads: bool = True
    fp16_grad_scale: float = 128.0
    skip_nonfinite: bool = True
    background: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def aabb(self) -> Tuple[float, float]:
        return (0.5 - self.aabb_scale / 2.0, 0.5 + self.aabb_scale / 2.0)

    @property
    def max_cascade(self) -> int:
        c = 0
        while (1 << c) < self.aabb_scale:
            c += 1
        return c

    @property
    def per_level_scale(self) -> float:
        return float(np.exp(np.log(self.desired_resolution * self.aabb_scale
                                   / self.base_resolution) / (self.n_levels - 1)))

    @property
    def min_cone_stepsize(self) -> float:
        return SQRT3 / MAX_STEP


def ngp_spec(run_net: dict) -> NGPSpec:
    """NGPSpec from a run_net configuration (the keys configs/ngp/*.py set;
    defaults as the JNeRF base config)."""
    aabb_scale = run_net["dataset"]["train"].get("aabb_scale", 1)
    fp16 = bool(run_net.get("fp16", False))
    optim, exp = run_net["optim"], run_net["expdecay"]
    enc = dict(run_net.get("encoder", {}).get("pos_encoder", {}))
    enc.update(run_net.get("hash_grid_overrides", {}))
    grid = {k: enc[k] for k in ("n_levels", "n_features", "base_resolution",
                                "log2_hashmap_size", "desired_resolution") if k in enc}
    net = run_net.get("model", {})
    return NGPSpec(
        aabb_scale=aabb_scale, **grid,
        density_hidden=net.get("density_n_neurons", 64),
        rgb_hidden=net.get("rgb_n_neurons", 64),
        n_coarse=run_net.get("n_coarse", 512), n_samples=run_net.get("n_samples", 64),
        n_compact=run_net.get("n_compact", 20 if aabb_scale <= 1 else 64),
        near_distance=run_net.get("near_distance", 0.2),
        lr=optim["lr"], eps=optim["eps"], betas=tuple(optim["betas"]),
        ema_decay=run_net["ema"]["decay"], decay_start=exp["decay_start"],
        decay_interval=exp["decay_interval"], decay_base=exp["decay_base"],
        huber_delta=run_net["loss"].get("delta", 0.1),
        n_grid_uniform=run_net.get("n_grid_uniform", 1 << 16),
        n_grid_nonuniform=run_net.get("n_grid_nonuniform", 1 << 16),
        fp16_grads=fp16, skip_nonfinite=fp16,
        background=tuple(float(c) for c in run_net.get("background_color", (1, 1, 1))))


# ---------------------------------------------------------------------------
# the brick3 table layout
# ---------------------------------------------------------------------------


class Bricks(NamedTuple):
    scales: Tuple[float, ...]
    dims: Tuple[int, ...]
    dense: Tuple[bool, ...]
    rows: Tuple[int, ...]
    groups: Tuple[Tuple[int, ...], ...]


def bricks(spec: NGPSpec) -> Bricks:
    """Per level: scale, bricks per axis, dense or hashed, rows; and the
    level groups (up to three consecutive hashed levels share a row, keyed
    by the finest; dense levels alone)."""
    per_level = max(1, (1 << spec.log2_hashmap_size) // ROW_VERTS)
    scales, dims, dense, rows = [], [], [], []
    for lv in range(spec.n_levels):
        scale = 2.0 ** (lv * np.log2(spec.per_level_scale)) * spec.base_resolution - 1.0
        res = int(np.ceil(scale)) + 1
        bx = (res + BRICK_CELLS - 1) // BRICK_CELLS
        scales.append(float(scale))
        dims.append(bx)
        dense.append(bx ** 3 <= per_level)
        rows.append(bx ** 3 if bx ** 3 <= per_level else per_level)
    hashed = [lv for lv in range(spec.n_levels) if not dense[lv]]
    groups = [(lv,) for lv in range(spec.n_levels) if dense[lv]]
    i = len(hashed) - 1
    while i >= 0:
        members = [hashed[i]]
        j = i - 1
        while (j >= 0 and len(members) < 3 and hashed[j] == members[-1] - 1
               and scales[members[-1]] / scales[hashed[j]] >= 4.0 / 3.0):
            members.append(hashed[j])
            j -= 1
        groups.append(tuple(reversed(members)))
        i = j
    return Bricks(tuple(scales), tuple(dims), tuple(dense), tuple(rows),
                  tuple(sorted(groups)))


def table_shapes(spec: NGPSpec) -> List[Tuple[int, int]]:
    b = bricks(spec)
    return [(b.rows[m[-1]], len(m) * spec.n_features * ROW_VERTS) for m in b.groups]


def level_taps(pos: torch.Tensor, spec: NGPSpec, b: Bricks):
    """For each level: (group, level, flat index [N, 8] of its 8 corner
    vertices, feature 0, in the group's table; trilinear weights [N, 8])."""
    F = spec.n_features
    c = torch.arange(8, device=pos.device)
    corner_lane = (c >> 2) * 25 + ((c >> 1) & 1) * 5 + (c & 1)
    for g, members in enumerate(b.groups):
        width = len(members) * F * ROW_VERTS
        key = members[-1]
        p = pos * b.scales[key] + 0.5
        brick = torch.floor(torch.floor(p) * (1.0 / BRICK_CELLS))
        u_key = p - brick * BRICK_CELLS
        if b.dense[key]:
            d = b.dims[key]
            bb = [torch.clamp(brick[:, a], 0.0, float(d - 1)) for a in range(3)]
            row = (bb[0] + bb[1] * d + bb[2] * (d * d)).to(torch.int32).to(torch.int64)
        else:
            bi = brick.to(torch.int64) & U32
            row = ((((bi[:, 0] * HASH_PRIMES[0]) & U32) ^ ((bi[:, 1] * HASH_PRIMES[1]) & U32)
                    ^ ((bi[:, 2] * HASH_PRIMES[2]) & U32)) & (b.rows[key] - 1))
        for j, lv in enumerate(members):
            if lv == key:
                u = u_key
            else:
                inv_r = 1.0 / (b.scales[key] / b.scales[lv])
                base_c = torch.floor((BRICK_CELLS * brick - 0.5) * inv_r + 0.5)
                u = (pos * b.scales[lv] + 0.5) - base_c
            i0 = torch.clamp(torch.floor(u), 0.0, BRICK_VERTS - 2.0)
            lo = torch.clamp_min(1.0 - torch.abs(u - i0), 0.0)
            hi = torch.clamp_min(1.0 - torch.abs(u - (i0 + 1.0)), 0.0)
            wx = torch.stack([lo[:, 0], hi[:, 0]], -1)[:, :, None, None]
            wy = torch.stack([lo[:, 1], hi[:, 1]], -1)[:, None, :, None]
            wz = torch.stack([lo[:, 2], hi[:, 2]], -1)[:, None, None, :]
            w = (wx * wy * wz).reshape(-1, 8)
            i0 = i0.to(torch.int64)
            lane0 = i0[:, 0] * 25 + i0[:, 1] * 5 + i0[:, 2]
            yield g, lv, (row * width + j * F * ROW_VERTS + lane0)[:, None] + corner_lane, w


def encode(tables: Sequence[torch.Tensor], pos: torch.Tensor, spec: NGPSpec,
           b: Bricks) -> torch.Tensor:
    """Positions [N, 3] in [0, 1] -> features [N, n_levels * F], in f32,
    differentiable in the tables (not in the positions)."""
    pos = pos.detach()
    F = spec.n_features
    feature = ROW_VERTS * torch.arange(F, device=pos.device)[:, None]
    out: List[Optional[torch.Tensor]] = [None] * spec.n_levels
    for g, lv, base, w in level_taps(pos, spec, b):
        vals = tables[g].reshape(-1)[base[:, None, :] + feature]       # [N, F, 8]
        out[lv] = (vals * w[:, None, :]).sum(-1)
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# field
# ---------------------------------------------------------------------------

LAYERS = ("density0", "density1", "rgb0", "rgb1", "rgb2")


def layer_shapes(spec: NGPSpec) -> Dict[str, Tuple[int, int]]:
    L = spec.n_levels * spec.n_features
    return {"density0": (L, spec.density_hidden),
            "density1": (spec.density_hidden, spec.geo_feat),
            "rgb0": (spec.geo_feat + 16, spec.rgb_hidden),
            "rgb1": (spec.rgb_hidden, spec.rgb_hidden),
            "rgb2": (spec.rgb_hidden, 3)}


def sh16(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 (16-component) real spherical harmonics of unit dirs [N, 3]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.31539156525252005 * (2.0 * zz - xx - yy), -1.0925484305920792 * xz,
        0.5462742152960396 * (xx - yy),
        -0.5900435899266435 * y * (3 * xx - yy), 2.890611442640554 * xy * z,
        -0.4570457994644658 * y * (4 * zz - xx - yy),
        0.3731763325901154 * z * (2 * zz - 3 * xx - 3 * yy),
        -0.4570457994644658 * x * (4 * zz - xx - yy), 1.445305721320277 * z * (xx - yy),
        -0.5900435899266435 * x * (xx - 3 * yy)], dim=-1)


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor], quant: str) -> torch.Tensor:
    """Bias-free MLP, ReLU between layers; the inputs, weights and each
    layer's output rounded as ``quant`` says."""
    h = quantize(x, quant)
    for i, w in enumerate(weights):
        h = h @ quantize(w, quant)
        if i < len(weights) - 1:
            h = torch.relu(h)
        h = quantize(h, quant)
    return h


class Field:
    """The NGP field on f32 parameters: tables (one per level group) and
    the five MLP weights."""

    def __init__(self, spec: NGPSpec, tables: Sequence[torch.Tensor],
                 weights: Dict[str, torch.Tensor], quant: str = "f32"):
        self.spec, self.quant = spec, quant
        self.b = bricks(spec)
        self.tables = [t.detach().float().clone().requires_grad_(True) for t in tables]
        self.weights = {n: weights[n].detach().float().clone().requires_grad_(True)
                        for n in LAYERS}

    def params(self) -> List[torch.Tensor]:
        return self.tables + [self.weights[n] for n in LAYERS]

    def features(self, pos: torch.Tensor) -> torch.Tensor:
        return quantize(encode(self.tables, pos, self.spec, self.b), self.quant)

    def density_raw(self, pos: torch.Tensor) -> torch.Tensor:
        w = self.weights
        return mlp(self.features(pos), [w["density0"], w["density1"]], self.quant)[:, :1]

    def __call__(self, pos: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        w = self.weights
        h = mlp(self.features(pos), [w["density0"], w["density1"]], self.quant)
        d = quantize(sh16(dirs * 2.0 - 1.0), self.quant)
        rgb = mlp(torch.cat([h, d], -1), [w["rgb0"], w["rgb1"], w["rgb2"]], self.quant)
        return torch.cat([rgb, h[:, :1]], -1)


class _DensityAct(torch.autograd.Function):
    """exp(min(raw, 30)); derivative exp(clip(raw, -15, 15))."""

    @staticmethod
    def forward(ctx, raw):
        ctx.save_for_backward(raw)
        return torch.exp(torch.clamp_max(raw, 30.0))

    @staticmethod
    def backward(ctx, g):
        (raw,) = ctx.saved_tensors
        return torch.exp(torch.clamp(raw, -15.0, 15.0)) * g


# ---------------------------------------------------------------------------
# occupancy grid
# ---------------------------------------------------------------------------


class Occupancy(NamedTuple):
    grid: torch.Tensor      # [C, G, G, G] f32, -1 where no camera sees
    bits: torch.Tensor      # [C, G, G, G] bool
    mean: torch.Tensor      # scalar


def cell_centers(level: int, device) -> torch.Tensor:
    idx = (torch.arange(GRID, dtype=torch.float32, device=device) + 0.5) / GRID - 0.5
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    return torch.stack([x, y, z], -1) * (2.0 ** level) + 0.5


def initial_occupancy(c2w: torch.Tensor, focal: torch.Tensor, W: int, H: int) -> Occupancy:
    """Zero grid, -1 in the cells no camera sees (c2w [n, 3, 4], +z
    forward; focal [n, 2])."""
    levels = []
    for level in range(N_CASCADES):
        pos = cell_centers(level, c2w.device).reshape(-1, 3)
        radius = 0.5 * SQRT3 * (2.0 ** level) / GRID
        seen = torch.zeros(pos.shape[0], dtype=torch.bool, device=c2w.device)
        for n in range(c2w.shape[0]):
            xyz = (pos - c2w[n, :, 3]) @ c2w[n, :, :3]
            x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            seen |= ((z > 0) & (torch.abs(x) - radius < z / focal[n, 0] * (W * 0.5))
                     & (torch.abs(y) - radius < z / focal[n, 1] * (H * 0.5)))
        levels.append(torch.where(seen, 0.0, -1.0).reshape(GRID, GRID, GRID))
    grid = torch.stack(levels)
    return Occupancy(grid, torch.zeros_like(grid, dtype=torch.bool),
                     torch.zeros((), device=grid.device))


def grid_draws(spec: NGPSpec, n: int, gen: torch.Generator, device):
    """The three draws of one sample set: cascade, first probe, jitter."""
    level = torch.randint(0, spec.max_cascade + 1, (n,), generator=gen, device=device)
    base = torch.randint(0, GRID ** 3, (n,), generator=gen, device=device)
    jitter = torch.rand((n, 3), generator=gen, device=device)
    return level, base, jitter


def grid_samples(occ: Occupancy, draws, thresh: float):
    level, base, jitter = (d for d in draws)
    n_cells = GRID ** 3
    level, base = level.to(torch.int64), base.to(torch.int64)
    steps = torch.arange(N_PROBES, dtype=torch.int64, device=base.device)
    probes = (base[:, None] + steps[None, :] * PROBE_STRIDE + PROBE_OFFSET) % n_cells
    hit = occ.grid.reshape(N_CASCADES, -1)[level[:, None], probes] > thresh
    first = hit.to(torch.uint8).argmax(dim=1)
    idx = torch.where(hit.any(dim=1), torch.gather(probes, 1, first[:, None])[:, 0],
                      probes[:, -1])
    cell = torch.stack([idx // (GRID * GRID), (idx // GRID) % GRID, idx % GRID],
                       -1).to(torch.float32)
    pos = ((cell + jitter) / GRID - 0.5) * torch.exp2(level.to(torch.float32))[:, None] + 0.5
    return pos, level * n_cells + idx


def bitfield(grid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.clamp_min(grid[0], 0.0).mean()
    bits = grid > torch.clamp_max(mean, MIN_OPTICAL_THICKNESS)
    lo, hi = GRID // 4, GRID // 4 + GRID // 2
    out = [bits[0]]
    for lv in range(1, N_CASCADES):
        h = GRID // 2
        pooled = out[lv - 1].reshape(h, 2, h, 2, h, 2).any(5).any(3).any(1)
        cur = bits[lv].clone()
        cur[lo:hi, lo:hi, lo:hi] |= pooled
        out.append(cur)
    return torch.stack(out), mean


@torch.no_grad()
def update_occupancy(spec: NGPSpec, field: Field, occ: Occupancy, draws) -> Occupancy:
    """One density-grid update: uniform and occupied-biased samples, a
    scatter-max of their optical thickness, the decayed max, the bits."""
    pos, idx = grid_samples(occ, draws[0], -0.01)
    pos_n, idx_n = grid_samples(occ, draws[1], MIN_OPTICAL_THICKNESS)
    pos, idx = torch.cat([pos, pos_n]), torch.cat([idx, idx_n])
    lo, hi = spec.aabb
    raw = field.density_raw(torch.clamp((pos - lo) / (hi - lo), 0.0, 1.0))[:, 0]
    optical = torch.exp(torch.clamp_max(raw, 30.0)) * spec.min_cone_stepsize
    tmp = torch.zeros_like(occ.grid)
    tmp.view(-1).scatter_reduce_(0, idx, optical, reduce="amax", include_self=True)
    grid = torch.where(occ.grid < 0.0, occ.grid, torch.maximum(occ.grid * 0.95, tmp))
    bits, mean = bitfield(grid)
    return Occupancy(grid, bits, mean)


def grid_value(volume: torch.Tensor, pos: torch.Tensor, single_mip: bool) -> torch.Tensor:
    """Value of a cascaded volume at world positions [..., 3]."""
    if single_mip:
        i = torch.clamp((pos * GRID).to(torch.int32), 0, GRID - 1).to(torch.int64)
        return volume[0].reshape(-1)[(i[..., 0] * GRID + i[..., 1]) * GRID + i[..., 2]]
    maxval = torch.abs(pos - 0.5).amax(-1)
    exponent = torch.floor(torch.log2(torch.clamp_min(maxval, 1e-10))) + 1
    mip = torch.clamp(exponent.to(torch.int32) + 1, 0, N_CASCADES - 1)
    p = (pos - 0.5) * torch.exp2(-mip.to(torch.float32))[..., None] + 0.5
    i = torch.clamp((p * GRID).to(torch.int32), 0, GRID - 1).to(torch.int64)
    return volume.reshape(-1)[mip.to(torch.int64) * GRID ** 3
                              + (i[..., 0] * GRID + i[..., 1]) * GRID + i[..., 2]]


# ---------------------------------------------------------------------------
# march and compositor
# ---------------------------------------------------------------------------


class Marched(NamedTuple):
    pos: torch.Tensor     # [N, K, 3] in [0, 1]
    dirs: torch.Tensor    # [N, K, 3] in [0, 1]
    dt: torch.Tensor      # [N, K]
    t: torch.Tensor       # [N, K]
    valid: torch.Tensor   # [N, K]


def march(spec: NGPSpec, occ: Occupancy, rays_o: torch.Tensor, rays_d: torch.Tensor,
          K: int, xi: Optional[torch.Tensor]) -> Marched:
    """The fused march: coarse probes of the density grid, bins past the
    coarse transmittance's eps dropped, K samples placed by inverse CDF over
    the live bins (xi [N, 1] jitters them; None: 0.5)."""
    N = rays_o.shape[0]
    lo, hi = spec.aabb
    inv = 1.0 / torch.where(rays_d == 0, 1e-10, rays_d)
    t1, t2 = (lo - rays_o) * inv, (hi - rays_o) * inv
    tmin = torch.clamp_min(torch.minimum(t1, t2).amax(-1), spec.near_distance)
    tmax = torch.maximum(torch.maximum(t1, t2).amin(-1), tmin)
    span = tmax - tmin
    single = spec.aabb_scale == 1
    thresh = torch.clamp_max(occ.mean, 0.01)
    Mc = spec.n_coarse
    frac = (torch.arange(Mc, dtype=torch.float32, device=rays_o.device) + 0.5) / Mc
    tc = tmin[:, None] + span[:, None] * frac[None, :]
    gval = grid_value(occ.grid, rays_o[:, None, :] + rays_d[:, None, :] * tc[..., None],
                      single)
    occ_c = gval > thresh
    wb = span / Mc
    od = torch.where(occ_c, torch.clamp_min(gval, 0.0) * (1.0 / spec.min_cone_stepsize)
                     * wb[:, None], 0.0)
    logT = torch.cat([torch.zeros((N, 1), device=rays_o.device),
                      -torch.cumsum(od, dim=1)[:, :-1]], dim=1)
    live = occ_c & (logT > float(np.log(np.float32(spec.early_stop_eps))))
    any_occ = live.any(dim=1)
    c = torch.cumsum(live.to(torch.float32), dim=1)
    n_occ = c[:, -1]
    dt = torch.maximum(n_occ * wb / K, torch.full_like(tmin, spec.min_cone_stepsize * 0.5))
    hit = span > 0.0
    inv_wb = torch.where(hit, 1.0 / torch.where(hit, wb, 1.0), 0.0)
    ks = torch.arange(K, dtype=torch.float32, device=rays_o.device)[None, :]
    r = (ks + (0.5 if xi is None else xi)) * (dt * inv_wb)[:, None]
    bin_idx = torch.searchsorted(c, r, right=True).to(torch.float32)
    t = tmin[:, None] + (bin_idx + (r - torch.floor(r))) * wb[:, None]
    pos = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
    inbox = ((pos >= lo) & (pos <= hi)).all(-1)
    valid = ((grid_value(occ.grid, pos, single) > thresh) & inbox & any_occ[:, None]
             & (r < n_occ[:, None]) & hit[:, None])
    return Marched(torch.clamp((pos - lo) / (hi - lo), 0.0, 1.0),
                   ((rays_d[:, None, :] + 1.0) * 0.5).expand(pos.shape),
                   dt[:, None].expand(t.shape), t, valid)


def composite(raw: torch.Tensor, m: Marched, bg: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NGP compositor: (rgb [N, 3], valid sample count)."""
    sigma = _DensityAct.apply(raw[..., 3])
    rgb_s = torch.sigmoid(raw[..., :3])
    sd = torch.where(m.valid, sigma * m.dt, 0.0)
    excl = torch.cumsum(torch.cat([torch.zeros_like(sd[..., :1]), sd[..., :-1]], -1), -1)
    T = torch.exp(-excl)
    w = torch.where(T > eps, T * (1.0 - torch.exp(-sd)), 0.0)
    w = torch.where(m.valid, w, 0.0)
    t_left = torch.clamp(1.0 - w.sum(-1, keepdim=True), 0.0, 1.0)
    return (rgb_s * w[..., None]).sum(-2) + t_left * bg, m.valid.sum()


def render_rays(spec: NGPSpec, field: Field, occ: Occupancy, rays_o, rays_d, bg,
                K: int, xi=None):
    m = march(spec, occ, rays_o, rays_d, K, xi)
    N = rays_o.shape[0]
    raw = field(m.pos.reshape(-1, 3), m.dirs.reshape(-1, 3)).reshape(N, K, 4)
    return composite(raw, m, bg, spec.early_stop_eps)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def huber(x: torch.Tensor, y: torch.Tensor, delta: float) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


class Adam:
    """Adam (eps inside the root) under ExpDecay, the learning rate read at
    the count before the increment; the fp16 gradient emulation (x scale,
    to float16, / scale) and the step skipped on a non-finite gradient."""

    def __init__(self, spec: NGPSpec, params: Sequence[torch.Tensor]):
        self.spec = spec
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def lr(self) -> float:
        s = self.spec
        n = max((self.count - s.decay_start) // s.decay_interval + 1, 0)
        return s.lr * s.decay_base ** n

    def gradients(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        s = self.spec.fp16_grad_scale
        if not self.spec.fp16_grads:
            return list(grads)
        return [(g * s).to(torch.float16).float() / s for g in grads]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        b1, b2 = self.spec.betas
        grads = self.gradients(grads)
        if self.spec.skip_nonfinite and not all(bool(torch.isfinite(g).all()) for g in grads):
            return
        lr = self.lr()
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            p.add_(-lr * (m / c1) / (torch.sqrt(v / c2) + self.spec.eps))


@torch.no_grad()
def ema_blend(spec: NGPSpec, params: Sequence[torch.Tensor],
              previous: Sequence[torch.Tensor], step: int) -> None:
    """The EMA blended into the live parameters after step ``step`` (0 first):
    p <- ((1-d) p + d v (1 - d^n)) / (1 - d^(n+1)), v the previous params."""
    d = spec.ema_decay
    n = step + 1
    old, new = 1.0 - d ** (n - 1), 1.0 / (1.0 - d ** n)
    for p, v in zip(params, previous):
        p.copy_(((1.0 - d) * p + d * v * old) * new)


# ---------------------------------------------------------------------------
# what a check compares
# ---------------------------------------------------------------------------


class TrainTrace(NamedTuple):
    losses: List[float]
    grad_norms: List[float]     # per leaf, the first step's gradient as Adam takes it
    change_norms: List[float]   # per leaf, |params after the steps - initial|


def train_steps(spec: NGPSpec, tables, weights, occ0: Occupancy, grid_draws_pair,
                batches, quant: str = "f32") -> TrainTrace:
    """Follow the trainer from its initial state: one grid update (the
    draws given), then one step per batch (rays_o, rays_d, target, bg, xi).
    Returns each step's loss, the per-leaf norms of the first step's
    gradient after the fp16 emulation, and the per-leaf norms of the change
    of the parameters over all the steps."""
    field = Field(spec, tables, weights, quant)
    params = field.params()
    start = [p.detach().clone() for p in params]
    adam = Adam(spec, params)
    losses, grad_norms = [], []
    with no_tf32():
        occ = update_occupancy(spec, field, occ0, grid_draws_pair)
        for s, (o, d, target, bg, xi) in enumerate(batches):
            rgb, _ = render_rays(spec, field, occ, o, d, bg, spec.n_compact, xi)
            loss = huber(rgb, target, spec.huber_delta).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            if s == 0:
                grad_norms = [float(torch.linalg.norm(g)) for g in adam.gradients(grads)]
            before = [p.detach().clone() for p in params]
            adam.step(params, grads)
            ema_blend(spec, params, before, s)
            losses.append(float(loss.detach()))
    change = [float(torch.linalg.norm(p.detach() - p0)) for p, p0 in zip(params, start)]
    return TrainTrace(losses, grad_norms, change)


@torch.no_grad()
def render_frame(spec: NGPSpec, field: Field, occ: Occupancy, rays_o, rays_d,
                 chunk: int = 16384) -> torch.Tensor:
    """A whole frame's rgb [N, 3] at the render setting (n_samples per ray,
    no jitter), chunk by chunk."""
    bg = torch.tensor(spec.background, device=rays_o.device)
    out = []
    with no_tf32():
        for a in range(0, rays_o.shape[0], chunk):
            rgb, _ = render_rays(spec, field, occ, rays_o[a:a + chunk], rays_d[a:a + chunk],
                                 bg, spec.n_samples)
            out.append(rgb)
    return torch.cat(out)

