"""Plain PyTorch reference of GARF's joint pose refinement (Gaussian-
Activated Radiance Fields, Chng et al., arXiv:2204.05735, on BARF's joint
refinement, Lin et al., arXiv:2104.06405) training past its pose gate, as
the MYC fork's barf-myc runs Easyship (options/Easyship.yaml over
options/base.yaml; model/garf.py, model/nerf_garf.py, model/nerf.py,
camera.py).

It imports only torch. Written out here, in the published code's order of
operations:

- the poses: se3_to_SE3 of each view's [6] correction (the Taylor series
  of sin(x)/x, (1-cos(x))/x^2 and (x-sin(x))/x^3 in theta = |w|, ten
  terms), composed before the given world-to-camera pose (camera.pose.
  compose([pose_refine, pose])), where the step is at or past
  ``start_pose_correct_iter``; the given pose below it;
- the rays of the drawn pixels: half-pixel centres through the inverse
  intrinsics, camera to world through the inverted pose, centre and
  unnormalised direction (camera.get_center_and_ray);
- stratified depths over the range (nerf.py sample_depth), the points,
  the unit view direction (F.normalize);
- the field: six feature layers of width 256 (the last 257 wide, its
  column 0 the relu density), the raw points back in at the input of
  layer 3, then the rgb head on [feature | view direction]; every hidden
  activation exp(-x^2 / 2 sigma^2) (nerf_garf.py gaussian); each layer
  one nn.Linear (weight [out, in]), as F.linear;
- quadrature compositing, the last interval 1e10 (nerf.py composite),
  with no background added (Easyship's setbg_opaque is false: the images
  themselves are over white);
- the MSE over the drawn pixels, its gradient to every MLP leaf and to
  the [views, 6] corrections, and two torch.optim.Adam steps with their
  ExponentialLR rates (the MLP's first, then the corrections', garf.py
  train_iteration).

Departures from the published code:

- the rays are made for the drawn pixels alone; the published code makes
  them for every pixel of every view and then gathers the drawn ones (the
  same values per ray);
- the pixel indices and the stratified jitter are inputs (the published
  code draws them inside the step: randperm of the pixels, then torch.rand);
- the weights are in the port's layout, kernels [in, out]; each layer
  runs as nn.Linear on the kernel's transpose;
- the gaussian is exp(x^2 * (-1 / 2 sigma^2)), the port's form, where the
  published code divides -x^2 by 2 sigma^2: the same function, rounded
  otherwise in the last bit of the exponent's argument, which sigma = 0.1
  amplifies (an argument near 50 moves the output by ~50 ulps) and the
  density's relu kink then turns into other samples' gradients. In the
  published form the first gradient read 5-6e-5 of a leaf's norm apart
  and 5-7e-4 of its largest element (CPU, 16x16, 8 samples, 3 seeds),
  against 4e-7 of the largest element in one form: the element-wise test
  (tests/test_torch_garf_reference.py) holds the field to its rounding
  only in one form;
- each learning rate is lr * gamma^step with the power in f32 (gamma
  rounded to f32), where ExponentialLR multiplies by gamma in double
  precision each step. This is the program's departure from the published
  schedule, kept for its parity with the JAX package (optax's
  exponential_decay computes in f32), and taken here so that the check
  reads the field's and the poses' arithmetic: at step 100,000 the f32
  power is 0.087% (the MLP's rate) and 0.28% (the corrections') above the
  double one, a difference the check does not see;
- the optimiser state is handed over at a global step (``train_steps``'s
  ``first_step``) with zero first moments and the given second moments
  (``nu``): Adam's step count for its bias corrections is first_step + 1
  on the first step.

Precision: f32 with TF32 off (``tf32=False``); the control is the same
arithmetic with TF32 matrix products (``tf32=True``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BETAS, EPS = (0.9, 0.999), 1e-8


@dataclasses.dataclass(frozen=True)
class GarfSpec:
    """What the reference needs of a barf-myc GARF configuration."""

    widths_feat: Tuple[int, ...] = (256,) * 6
    widths_rgb: Tuple[int, ...] = (128, 3)
    skip: Tuple[int, ...] = (3,)
    sigma: float = 0.1
    depth_range: Tuple[float, float] = (2.0, 6.0)
    n_samples: int = 128
    rand_rays: int = 2048
    lr: float = 1e-4
    lr_end: float = 5e-5
    lr_pose: float = 3e-3
    lr_pose_end: float = 1e-5
    max_iter: int = 200000
    start_pose_correct_iter: int = 80000


def garf_spec(barf: dict) -> GarfSpec:
    """GarfSpec from a loaded barf-myc options tree (``_parent_`` merged),
    read as options.py and the GARF model read it."""
    arch, nerf, optim = barf["arch"], barf["nerf"], barf["optim"]
    return GarfSpec(widths_feat=tuple(arch["layers_feat"][1:]),
                    widths_rgb=tuple(arch["layers_rgb"][1:]), skip=tuple(arch["skip"]),
                    depth_range=tuple(float(v) for v in nerf["depth"]["range"]),
                    n_samples=nerf["sample_intvs"], rand_rays=nerf["rand_rays"],
                    lr=optim["lr"], lr_end=optim["lr_end"], lr_pose=optim["lr_pose"],
                    lr_pose_end=optim["lr_pose_end"], max_iter=barf["max_iter"],
                    start_pose_correct_iter=barf["start_pose_correct_iter"])


def layer_widths(spec: GarfSpec) -> List[Tuple[int, int]]:
    """(in, out) of every layer in call order: the feature layers (the
    points back in at the skips, the last one unit wider for the density),
    then the rgb head on [feature | view direction]."""
    out, fan_in = [], 3
    for li, w in enumerate(spec.widths_feat):
        fan_in += 3 if li in spec.skip else 0
        out.append((fan_in, w + 1 if li == len(spec.widths_feat) - 1 else w))
        fan_in = w
    fan_in += 3
    for w in spec.widths_rgb:
        out.append((fan_in, w))
        fan_in = w
    return out


def leaf_names(spec: GarfSpec) -> List[str]:
    """The MLP's leaves in the port's order: each layer's kernel, then its
    bias."""
    return [f"Dense_{i}.{kind}" for i in range(len(layer_widths(spec)))
            for kind in ("kernel", "bias")]


def macs_per_sample(spec: GarfSpec) -> int:
    return sum(a * b for a, b in layer_widths(spec))


# ---------------------------------------------------------------------------
# camera.py
# ---------------------------------------------------------------------------


def skew(w: torch.Tensor) -> torch.Tensor:
    w0, w1, w2 = w.unbind(dim=-1)
    O = torch.zeros_like(w0)
    return torch.stack([torch.stack([O, -w2, w1], dim=-1),
                        torch.stack([w2, O, -w0], dim=-1),
                        torch.stack([-w1, w0, O], dim=-1)], dim=-2)


def _taylor(x: torch.Tensor, step, nth: int = 10) -> torch.Tensor:
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom = step(denom, i)
        ans = ans + (-1) ** i * x ** (2 * i) / denom
    return ans


def taylor_A(x):  # sin(x)/x
    return _taylor(x, lambda d, i: d * (2 * i) * (2 * i + 1) if i > 0 else d)


def taylor_B(x):  # (1-cos(x))/x^2
    return _taylor(x, lambda d, i: d * (2 * i + 1) * (2 * i + 2))


def taylor_C(x):  # (x-sin(x))/x^3
    return _taylor(x, lambda d, i: d * (2 * i + 2) * (2 * i + 3))


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """[..., 6] (w | u) -> [..., 3, 4] (camera.Lie.se3_to_SE3)."""
    w, u = wu.split([3, 3], dim=-1)
    wx = skew(w)
    theta = w.norm(dim=-1)[..., None, None]
    I = torch.eye(3, device=w.device, dtype=torch.float32)
    A, B, C = taylor_A(theta), taylor_B(theta), taylor_C(theta)
    R = I + A * wx + B * wx @ wx
    V = I + B * wx + C * wx @ wx
    return torch.cat([R, V @ u[..., None]], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return torch.cat([R_inv, (-R_inv @ t)], dim=-1)


def compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return torch.cat([R_b @ R_a, (R_b @ t_a + t_b)], dim=-1)


def to_hom(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def center_and_ray(pose: torch.Tensor, intr: torch.Tensor, xy: torch.Tensor):
    """Centres and unnormalised directions [B, R, 3] of pixel centres xy
    [R, 2] in every view: pose [B, 3, 4] world to camera, intr [B, 3, 3]."""
    xy = xy[None].expand(pose.shape[0], -1, -1)
    grid = to_hom(xy) @ intr.inverse().transpose(-1, -2)
    center = torch.zeros_like(grid)
    pose_inv = invert(pose)
    grid = to_hom(grid) @ pose_inv.transpose(-1, -2)
    center = to_hom(center) @ pose_inv.transpose(-1, -2)
    return center, grid - center


def pixel_xy(ray_idx: torch.Tensor, W: int) -> torch.Tensor:
    """Pixel centres (x, y) [R, 2] of flat indices into an H x W image."""
    return torch.stack([(ray_idx % W).float() + 0.5,
                        torch.div(ray_idx, W, rounding_mode="floor").float() + 0.5], -1)


# ---------------------------------------------------------------------------
# nerf.py, nerf_garf.py
# ---------------------------------------------------------------------------


def gaussian(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return torch.exp(torch.square(x) * (-1.0 / (2.0 * sigma ** 2)))


def field(spec: GarfSpec, p: Dict[str, torch.Tensor], points: torch.Tensor,
          ray_unit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb [..., 3], density [...])."""
    n_feat = len(spec.widths_feat)

    def layer(i, x):
        return F.linear(x, p[f"Dense_{i}.kernel"].t(), p[f"Dense_{i}.bias"])

    feat = points
    density = None
    for li in range(n_feat):
        if li in spec.skip:
            feat = torch.cat([feat, points], dim=-1)
        feat = layer(li, feat)
        if li == n_feat - 1:
            density = torch.relu(feat[..., 0])
            feat = feat[..., 1:]
        feat = gaussian(feat, spec.sigma)
    feat = torch.cat([feat, ray_unit], dim=-1)
    for li in range(len(spec.widths_rgb)):
        feat = layer(n_feat + li, feat)
        if li != len(spec.widths_rgb) - 1:
            feat = gaussian(feat, spec.sigma)
    return torch.sigmoid(feat), density


def composite(ray, rgb_samples, density_samples, depth_samples) -> torch.Tensor:
    """rgb [B, R, 3] of the quadrature, no background added."""
    ray_length = ray.norm(dim=-1, keepdim=True)
    intv = depth_samples[..., 1:, 0] - depth_samples[..., :-1, 0]
    intv = torch.cat([intv, torch.empty_like(intv[..., :1]).fill_(1e10)], dim=2)
    sigma_delta = density_samples * (intv * ray_length)
    alpha = 1 - (-sigma_delta).exp()
    T = (-torch.cat([torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]],
                    dim=2).cumsum(dim=2)).exp()
    prob = (T * alpha)[..., None]
    return (rgb_samples * prob).sum(dim=2)


def loss(spec: GarfSpec, p: Dict[str, torch.Tensor], se3: torch.Tensor, step: int,
         poses: torch.Tensor, intr: torch.Tensor, pixels: torch.Tensor,
         ray_idx: torch.Tensor, rand: torch.Tensor, W: int) -> torch.Tensor:
    """The MSE of one step: pixels [B, H * W, 3], ray_idx [R], rand
    [B, R, N, 1] the stratified jitter."""
    if step >= spec.start_pose_correct_iter:
        poses = compose_pair(se3_to_SE3(se3), poses)
    center, ray = center_and_ray(poses, intr, pixel_xy(ray_idx, W))
    lo, hi = spec.depth_range
    n = spec.n_samples
    depth = (rand + torch.arange(n, device=rand.device)[None, None, :, None].float()
             ) / n * (hi - lo) + lo
    points = center[..., None, :] + ray[..., None, :] * depth
    ray_unit = F.normalize(ray, dim=-1)[..., None, :].expand_as(points)
    rgb_s, density_s = field(spec, p, points, ray_unit)
    rgb = composite(ray, rgb_s, density_s, depth)
    return ((rgb - pixels[:, ray_idx]) ** 2).mean()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class Adam:
    """torch.optim.Adam's update (weight decay 0) at the rate of an
    ExponentialLR from ``lr`` to ``lr_end`` over ``max_iter`` steps,
    resumed at ``step`` with zero first moments and the second moments
    ``nu`` (zero where None)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, lr_end: float,
                 max_iter: int, step: int, nu: Optional[Sequence[torch.Tensor]] = None):
        self.lr, self.gamma, self.step_count = lr, (lr_end / lr) ** (1.0 / max_iter), step
        self.m = [torch.zeros_like(q) for q in params]
        self.v = ([torch.zeros_like(q) for q in params] if nu is None
                  else [v.detach().float().clone() for v in nu])

    def rate(self) -> float:
        """lr * gamma^step, the power in f32 (the module's docstring)."""
        f32 = torch.float32
        return float(torch.tensor(self.lr, dtype=f32) * torch.pow(
            torch.tensor(self.gamma, dtype=f32), torch.tensor(float(self.step_count), dtype=f32)))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        lr = self.rate()
        self.step_count += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.step_count, 1 - b2 ** self.step_count
        for q, g, m, v in zip(params, grads, self.m, self.v):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            q.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(EPS), value=-lr / c1)


def gradients(spec: GarfSpec, init: Dict[str, torch.Tensor], se3: torch.Tensor, step: int,
              images: torch.Tensor, poses: torch.Tensor, intr: torch.Tensor,
              ray_idx: torch.Tensor, rand: torch.Tensor) -> Tuple[float, List[torch.Tensor]]:
    """(the loss, its gradients to the MLP's leaves in leaf_names order and
    to the corrections, last) of one step at global step ``step``."""
    names = leaf_names(spec)
    p = {n: init[n].detach().float().clone().requires_grad_(True) for n in names}
    se3 = se3.detach().float().clone().requires_grad_(True)
    B, H, W, _ = images.shape
    total = loss(spec, p, se3, step, poses, intr, images.reshape(B, H * W, 3), ray_idx, rand, W)
    wrt = [p[n] for n in names] + [se3]
    grads = torch.autograd.grad(total, wrt, allow_unused=True)
    return float(total.detach()), [torch.zeros_like(q) if g is None else g
                                   for q, g in zip(wrt, grads)]


class TrainTrace(NamedTuple):
    losses: List[float]
    grad_norms: List[float]          # the MLP's leaves, leaf_names order
    change_norms: List[float]
    pose_grad: torch.Tensor          # [views, 6], the first step's
    pose_change: torch.Tensor        # [views, 6], over the steps
    states: List[Tuple[Dict[str, torch.Tensor], torch.Tensor]]  # (leaves, corrections) before each step


def train_steps(spec: GarfSpec, init: Dict[str, torch.Tensor], se3_init: torch.Tensor,
                images: torch.Tensor, poses: torch.Tensor, intr: torch.Tensor,
                batches, first_step: int, nu: Optional[Dict[str, torch.Tensor]] = None,
                tf32: bool = False, rays: Optional[int] = None,
                states: Optional[Sequence[Tuple[Dict[str, torch.Tensor], torch.Tensor]]] = None
                ) -> TrainTrace:
    """One step per batch (ray_idx [R], rand [B, R, N, 1]) from global step
    ``first_step``: images [B, H, W, 3], poses [B, 3, 4] world to camera,
    intr [B, 3, 3]; ``nu``: both Adams' second moments by leaf name and
    "se3_refine" (zero where None). ``rays``: only the first ``rays`` of each batch's
    pixels (the half-batch control). ``states``: (the leaves by name, the
    corrections) to take each step from, in place of where the last step
    left them (the check's: each step from the program's own state; the
    Adams' moments stay the reference's). Returns each step's loss, the
    per-leaf norms of the first gradient and of the change over the steps
    (the sum of the steps' updates), the corrections' first gradient and
    change, and the state each step started from."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        names = leaf_names(spec)
        p = {n: init[n].detach().float().clone().requires_grad_(True) for n in names}
        se3 = se3_init.detach().float().clone().requires_grad_(True)
        B, H, W, _ = images.shape
        pixels = images.reshape(B, H * W, 3)
        mlp = [p[n] for n in names]
        opts = (Adam(mlp, spec.lr, spec.lr_end, spec.max_iter, first_step,
                     None if nu is None else [nu[n] for n in names]),
                Adam([se3], spec.lr_pose, spec.lr_pose_end, spec.max_iter, first_step,
                     None if nu is None else [nu["se3_refine"]]))
        losses, grad_norms, pose_grad, started = [], [], None, []
        change = {n: torch.zeros_like(p[n]) for n in names}
        pose_change = torch.zeros_like(se3)
        for s, (ray_idx, rand) in enumerate(batches):
            if states is not None:
                with torch.no_grad():
                    for n in names:
                        p[n].copy_(states[s][0][n])
                    se3.copy_(states[s][1])
            started.append(({n: p[n].detach().clone() for n in names}, se3.detach().clone()))
            if rays is not None:
                ray_idx, rand = ray_idx[:rays], rand[:, :rays]
            total = loss(spec, p, se3, first_step + s, poses, intr, pixels, ray_idx, rand, W)
            grads = torch.autograd.grad(total, mlp + [se3], allow_unused=True)
            grads = [torch.zeros_like(q) if g is None else g for q, g in zip(mlp + [se3], grads)]
            if s == 0:
                grad_norms = [float(torch.linalg.norm(g)) for g in grads[:-1]]
                pose_grad = grads[-1].detach().clone()
            opts[0].step(mlp, grads[:-1])
            opts[1].step([se3], grads[-1:])
            with torch.no_grad():
                for n in names:
                    change[n] += p[n] - started[-1][0][n]
                pose_change += se3 - started[-1][1]
            losses.append(float(total.detach()))
        return TrainTrace(losses, grad_norms,
                          [float(torch.linalg.norm(change[n])) for n in names], pose_grad,
                          pose_change, started)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

