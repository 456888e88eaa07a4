"""Plain PyTorch reference of NeRF++ on TensoRF (the NerfPlusPlus model of
the TensoRF fork, tensorf-myc models/nerfplusplus.py, as configs/Scarf.txt
sets it up) training at a fixed stage past its last event.

It imports only torch, numpy and the TensoRF reference beside it
(``reference/tensorf.py``: the factor sampling, the density, the MLP_Fea
shader, the alpha mask and its gate, the loss and the Adams). Written out
here:

- the foreground: fixed-count samples from ``near`` to the ray's exit from
  the sphere of radius ``radii`` about the origin, jittered inside their
  intervals, clipped to the AABB and gated by the alpha mask, composited
  with their transmittance product;
- the background: inverse depths over [0, radii], jittered the same way,
  run from the sphere outward; each sample's inverted-sphere point
  (x', y', z', 1/r) found by rotating the ray's exit point about the axis
  o x exit (Rodrigues), embedded as [x, sin 2^i x, cos 2^i x] with the view
  direction, through the background MLP (a skip after layer D // 2, sigma |.|, the
  256-wide remap, the W // 2 view layer, a sigmoid), composited with its
  own transmittance, the last interval 1e10;
- the composition: the foreground's leftover transmittance, kept where it
  is above 0.1, weights the background's colour and depth.

The background is written in nerfplusplus.py's order of operations
(intersect_sphere and depth2pts_outside as published, each layer one
addmm as nn.Linear), so that its f32 values are the program's wherever the
program's arithmetic is the same: the |sigma| and ReLU kinks of 524,288
rows then fall alike on both sides, and a gradient reading compares the
gradient's flow, not which few rows lie within an ulp of a kink (one such
row moved the worst leaf's gradient by 2.5e-4 with the background in
another order: PERF.md, section 2). The foreground's factors stay the
TensoRF reference's own gathers.

Departures from nerfplusplus.py (as the port follows it): the background
samples are put in compositing order (from the sphere outward) before
their points are found, where the model finds the points in its own order
and flips the embedded inputs; element for element the same values. The
inverse depths are spaced as radius * i * (1 / (n - 1)) rather than by
torch.linspace (the port's spacing). The loss is the TensoRF reference's
(MSE, L1 and TV at the configuration's weights, all nought for Scarf but
the MSE); the colour is not clipped, as the model's is not.

Precision: f32 with TF32 off (``tf32=False``); the control is the same
arithmetic with TF32 matrix products (``tf32=True``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from . import tensorf as ref

TINY = 1e-6
HUGE = 1e10


@dataclasses.dataclass(frozen=True)
class NerfPPSpec:
    """What the reference needs of a NerfPlusPlus configuration: the
    foreground's TensoRF spec and the background's settings."""

    fg: ref.TensoRFSpec
    radii: float = 20.0
    bg_samples: int = 512
    bg_D: int = 4
    bg_freq: int = 4
    bg_view_freq: int = 2
    bg_W: int = 128


def nerfpp_spec(cfg: dict) -> NerfPPSpec:
    """NerfPPSpec from a configuration file's ``tensorf`` section, with
    set_nerfplusplus's defaults (nerfplusplus.py) where it sets none."""
    a = cfg["tensorf"]
    return NerfPPSpec(fg=ref.tensorf_spec(cfg), radii=float(a.get("radii", 20.0)),
                      bg_samples=a.get("bg_samples", 512), bg_D=a.get("bg_D", 4),
                      bg_freq=a.get("bg_freq", 4), bg_view_freq=a.get("bg_view_freq", 2))


def skip(spec: NerfPPSpec) -> int:
    """The base layer whose input takes the embedded points back in: the one
    after the D // 2-th hidden layer (MLPNet's skips = [D // 2])."""
    return spec.bg_D // 2 + 1


def bg_widths(spec: NerfPPSpec) -> List[Tuple[int, int]]:
    """(in, out) of the background MLP's layers, in order: the D base
    layers (the embedded points back in at the input of layer skip(spec)),
    sigma, the 256-wide remap, the view layer, rgb."""
    W, pts = spec.bg_W, 4 * (1 + 2 * spec.bg_freq)
    view = 3 * (1 + 2 * spec.bg_view_freq)
    out = [(pts, W)]
    out += [(W + (pts if k == skip(spec) else 0), W) for k in range(1, spec.bg_D)]
    return out + [(W, 1), (W, 256), (256 + view, W // 2), (W // 2, 3)]


def leaf_shapes(spec: NerfPPSpec) -> Dict[str, Tuple[int, ...]]:
    """Every parameter in the trainer's leaf order: the factor grids, then
    the net group (basis, background MLP, shading MLP)."""
    base = ref.leaf_shapes(spec.fg)
    out = {n: s for n, s in base.items() if not n.startswith("mlp.")}
    for k, (a, b) in enumerate(bg_widths(spec)):
        out[f"bg_net.Dense_{k}.kernel"] = (a, b)
        out[f"bg_net.Dense_{k}.bias"] = (b,)
    out.update({n: s for n, s in base.items() if n.startswith("mlp.")})
    return out


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def jitter(z: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """Each depth moved inside its interval (between the midpoints with its
    neighbours; the ends stay inside the range) by ``draw`` in [0, 1)."""
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    lo = torch.cat([z[:, :1], mid], 1)
    hi = torch.cat([mid, z[:, -1:]], 1)
    return lo + (hi - lo) * draw


def closest(o: torch.Tensor, d: torch.Tensor):
    """(depth of the ray's point closest to the origin, that point)."""
    t = -torch.sum(d * o, -1) / torch.sum(d * d, -1)
    return t, o + t[..., None] * d


def sphere_exit(o: torch.Tensor, d: torch.Tensor, radius: float) -> torch.Tensor:
    """Depth at which the ray leaves the sphere of ``radius`` about the origin
    (intersect_sphere: the half chord times 1 / |d|)."""
    t, p = closest(o, d)
    inv = 1.0 / torch.linalg.norm(d, dim=-1)
    return t + torch.sqrt(torch.clamp(radius * radius - torch.sum(p * p, -1), min=0.0)) * inv


def inverse_depths(n_rays: int, n: int, radius: float, device) -> torch.Tensor:
    """[n_rays, n] inverse-depth parameters evenly spaced over [0, radius]:
    radius * i * (1 / (n - 1)), the last one radius."""
    s = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    z = torch.cat([radius * s, torch.full((1,), radius, device=device)])
    return z[None].expand(n_rays, n)


def inverted_points(o: torch.Tensor, d: torch.Tensor, z: torch.Tensor,
                    radius: float) -> torch.Tensor:
    """The inverted-sphere points (x', y', z', z) [N, B, 4] of inverse-depth
    parameters z [N, B] (depth2pts_outside): the ray's exit point on the
    sphere rotated about o x exit by the angle between its bearing and the
    sample's."""
    t, p = closest(o, d)
    pn = torch.linalg.norm(p, dim=-1)
    inv = 1.0 / torch.linalg.norm(d, dim=-1)
    half = torch.sqrt(torch.clamp(radius * radius - pn ** 2, min=0.0)) * inv
    exit_ = o + (t + half)[:, None] * d
    axis = torch.linalg.cross(o, exit_, dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + TINY)
    phi = torch.asin(torch.clamp(pn / radius, -1.0, 1.0))
    theta = torch.asin(torch.clamp(pn[:, None] * z / (radius * radius), -1.0, 1.0))
    ang = (phi[:, None] - theta)[..., None]
    e, k = exit_[:, None, :], axis[:, None, :]
    rotated = (e * torch.cos(ang) + torch.linalg.cross(axis, exit_, dim=-1)[:, None, :]
               * torch.sin(ang) + k * torch.sum(k * e, -1, keepdim=True) * (1.0 - torch.cos(ang)))
    return torch.cat([rotated, z[..., None]], -1)


def embed(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...] over ``freqs`` octaves."""
    parts = [x]
    for i in range(freqs):
        parts += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(parts, -1)


def bg_mlp(spec: NerfPPSpec, p, pts_e: torch.Tensor, view_e: torch.Tensor):
    """(rgb [..., 3], sigma [...]) of the background MLP; each layer one
    addmm over the rows, as nn.Linear."""
    def dense(k, x):
        rows = torch.addmm(p[f"bg_net.Dense_{k}.bias"], x.reshape(-1, x.shape[-1]),
                           p[f"bg_net.Dense_{k}.kernel"])
        return rows.reshape(x.shape[:-1] + (rows.shape[-1],))

    h = torch.relu(dense(0, pts_e))
    for k in range(1, spec.bg_D):
        h = torch.relu(dense(k, torch.cat([pts_e, h], -1) if k == skip(spec) else h))
    D = spec.bg_D
    sigma = torch.abs(dense(D, h))[..., 0]
    v = torch.relu(dense(D + 2, torch.cat([dense(D + 1, h), view_e], -1)))
    return torch.sigmoid(dense(D + 3, v)), sigma


# ---------------------------------------------------------------------------
# forward, training
# ---------------------------------------------------------------------------


class Forward(NamedTuple):
    rgb: torch.Tensor        # [N, 3]
    depth: torch.Tensor      # [N]
    valid: torch.Tensor      # [N, S] gated foreground samples
    shaded: torch.Tensor     # [N, S] foreground samples shaded
    lam: torch.Tensor        # [N] the background's weight: leftover transmittance, gated


def forward(spec: NerfPPSpec, p, vol: torch.Tensor, aabb: torch.Tensor, rays: torch.Tensor,
            draws) -> Forward:
    """NeRF++ on rays [N, 6] with draws (fg [N, S], bg [N, bg_samples])."""
    fs = spec.fg
    o, d = rays[:, :3], rays[:, 3:6]
    d_fg, d_bg = draws
    N, S, dev = o.shape[0], fs.n_samples, o.device

    # foreground, from near to the sphere's exit
    near = fs.near_far[0]
    far = sphere_exit(o, d, spec.radii)
    z = near + ((far - near) / (S - 1))[:, None] * torch.arange(S, dtype=torch.float32,
                                                               device=dev)[None]
    z = jitter(z, d_fg)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    valid = ~torch.logical_or(aabb[0] > pts, pts > aabb[1]).any(-1)
    valid = valid & ref.gate(vol, aabb, pts)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1)
    xyz = ref.normalize(aabb, pts).reshape(-1, 3)
    idx = valid.reshape(-1).nonzero().squeeze(1)
    sigma = torch.zeros(valid.numel(), device=dev).index_put(
        (idx,), ref.density(fs, p, xyz[idx])).reshape(valid.shape)
    alpha = 1.0 - torch.exp(-sigma * (dists * fs.distance_scale))
    T = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
    w = alpha * T[:, :-1]
    shaded = w > fs.weight_thres
    ia = shaded.reshape(-1).nonzero().squeeze(1)
    rgb_a = ref.shade(fs, p, xyz[ia], d[torch.div(ia, S, rounding_mode="floor")])
    rgb_s = torch.zeros((valid.numel(), 3), device=dev).index_put((ia,), rgb_a)
    fg_rgb = (w[..., None] * rgb_s.reshape(N, S, 3)).sum(1)
    fg_depth = (w * z).sum(1)
    lam = torch.cumprod(1.0 - alpha + TINY, -1)[:, -1]

    # background, in compositing order: inverse depths from radii down to 0
    B = spec.bg_samples
    zb = torch.flip(jitter(inverse_depths(N, B, spec.radii, dev), d_bg), (1,))
    pts_e = embed(inverted_points(o, d, zb, spec.radii), spec.bg_freq)
    u = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    view_e = embed(u, spec.bg_view_freq)[:, None, :].expand(N, B, -1)
    bg_rgb, bg_sigma = bg_mlp(spec, p, pts_e, view_e)
    gaps = torch.cat([zb[:, :-1] - zb[:, 1:], torch.full_like(zb[:, :1], HUGE)], 1)
    a = 1.0 - torch.exp(-bg_sigma * gaps)
    Tb = torch.cumprod(1.0 - a + TINY, 1)[:, :-1]
    wb = a * torch.cat([torch.ones_like(Tb[:, :1]), Tb], 1)
    bg = (wb[..., None] * bg_rgb).sum(1)
    bg_depth = (wb * zb).sum(1)

    lam = torch.where(lam > 0.1, lam, torch.zeros_like(lam))
    return Forward(fg_rgb + lam[:, None] * bg, fg_depth + lam * bg_depth, valid, shaded, lam)


class TrainTrace(NamedTuple):
    losses: List[float]
    grad_norms: List[float]
    change_norms: List[float]


def train_steps(spec: NerfPPSpec, init: Dict[str, torch.Tensor], batches, first_step: int,
                tf32: bool = False) -> TrainTrace:
    """The alpha mask of the initial field, then one step per batch (rays
    [N, 6], target [N, 3], draws (fg [N, S], bg [N, bg_samples])) from
    global step ``first_step``. Returns each step's loss, the per-leaf norms
    of the first gradient and of the change over the steps, leaves in
    leaf_shapes order."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        names = list(leaf_shapes(spec))
        p = {n: init[n].detach().float().clone().requires_grad_(True) for n in names}
        dev = p[names[0]].device
        aabb = torch.tensor(spec.fg.aabb, dtype=torch.float32, device=dev)
        vol = ref.alpha_mask(spec.fg, p, aabb)
        spatial = [n for n in names if ref.is_spatial(n)]
        net = [n for n in names if not ref.is_spatial(n)]
        opts = (ref.Adam([p[n] for n in spatial], spec.fg.lr_init, spec.fg.lr_factor),
                ref.Adam([p[n] for n in net], spec.fg.lr_basis, spec.fg.lr_factor))
        losses, grad_norms = [], []
        for s, (rays, target, draws) in enumerate(batches):
            fwd = forward(spec, p, vol, aabb, rays, draws)
            total = ref.loss(spec.fg, p, fwd, target, first_step + s)
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
