"""Synthetic multi-view scenes (counterpart of myc_nerfs_tpu/data/synthetic.py).

Ground-truth images of a closed-form emissive field, volume-rendered at a
high sample count from orbit cameras: the data of run_net's ``--synthetic``
mode and of the quality runs (cli/quality_scale.py). ``make_scene`` renders
the two-blob field (or, ``textured``, the striped ball); ``make_detail_scene``
the detail-rich sphere at quality-run scale (``outer``: with a torus outside
the unit box); ``make_cascade_scene`` the sphere and torus from four rings
for aabb_scale 4. ``SyntheticNGPData`` holds the rays and pixels the NGP
trainer draws from a scene.

The detail and cascade scenes render on ``device`` (their 256^2 x 512-sample
ground truth is slow on a CPU) in row strips, and return their tensors on
the CPU.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geom import rays as rays_lib
from ..render.composite import composite_nerf


class SyntheticScene(NamedTuple):
    images: torch.Tensor  # [N, H, W, 3]
    poses: torch.Tensor   # [N, 3, 4] world->cam (BARF convention)
    intr: torch.Tensor    # [N, 3, 3]
    H: int
    W: int
    depth_range: Tuple[float, float]


def analytic_field(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A smooth two-blob emissive field: (rgb [..., 3], sigma [...])."""
    c1 = torch.tensor([0.35, 0.0, 0.0], device=points.device)
    c2 = torch.tensor([-0.35, 0.15, 0.1], device=points.device)
    d1 = ((points - c1) ** 2).sum(-1)
    d2 = ((points - c2) ** 2).sum(-1)
    sigma = 18.0 * torch.exp(-d1 / 0.05) + 14.0 * torch.exp(-d2 / 0.08)
    w1 = torch.exp(-d1 / 0.05)[..., None]
    w2 = torch.exp(-d2 / 0.08)[..., None]
    col1 = torch.tensor([0.9, 0.25, 0.2], device=points.device)
    col2 = torch.tensor([0.2, 0.45, 0.95], device=points.device)
    rgb = (w1 * col1 + w2 * col2) / (w1 + w2 + 1e-8)
    return rgb, sigma


def analytic_field_textured(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A dense ball with high-frequency colour stripes."""
    r = torch.linalg.norm(points, dim=-1)
    sigma = 40.0 * torch.sigmoid((0.6 - r) * 30.0)
    stripes = 0.5 + 0.5 * torch.sin(12.0 * points[..., 0]) * torch.sin(12.0 * points[..., 1])
    rings = 0.5 + 0.5 * torch.cos(10.0 * points[..., 2])
    rgb = torch.stack([stripes, rings, 1.0 - stripes * rings], dim=-1)
    return rgb, sigma


def analytic_field_detail(points: torch.Tensor,
                          outer: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """An opaque sphere whose surface is displaced by multi-frequency
    harmonics and painted with three texture octaves (up to ~180 cycles per
    world unit); with ``outer``, a textured torus at world radius ~1.9 adds
    content outside the unit box."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = torch.linalg.norm(points, dim=-1)
    theta = torch.atan2(y, x)
    phi = torch.arccos(torch.clamp(z / torch.clamp_min(r, 1e-6), -1.0, 1.0))
    disp = (0.05 * torch.sin(7.0 * theta) * torch.sin(5.0 * phi + 1.3)
            + 0.02 * torch.sin(19.0 * theta + 2.1) * torch.sin(13.0 * phi)
            + 0.008 * torch.sin(41.0 * theta) * torch.sin(37.0 * phi + 0.7))
    r_s = 0.48 + disp
    sigma = 60.0 * torch.sigmoid((r_s - r) * 150.0)
    t1 = torch.sin(23.0 * x + 31.0 * y) * torch.sin(27.0 * z - 17.0 * x)
    t2 = torch.sin(71.0 * x - 53.0 * z + 1.0) * torch.sin(61.0 * y + 0.5)
    t3 = torch.sin(181.0 * x + 167.0 * y + 149.0 * z)
    red = torch.clamp(0.55 + 0.28 * t1 + 0.13 * t2 + 0.06 * t3, 0.0, 1.0)
    grn = torch.clamp(0.45 + 0.24 * torch.sin(2.0 * theta + 4.0 * phi)
                      + 0.18 * t2 - 0.08 * t3, 0.0, 1.0)
    blu = torch.clamp(0.50 - 0.22 * t1 + 0.20
                      * torch.sin(43.0 * y + 29.0 * z) * torch.sin(37.0 * x), 0.0, 1.0)
    rgb = torch.stack([red, grn, blu], dim=-1)
    if outer:
        dring = torch.sqrt((torch.sqrt(x ** 2 + y ** 2) - 1.9) ** 2 + (z - 0.2) ** 2)
        s_ring = 80.0 * torch.sigmoid((0.16 - dring) * 120.0)
        stripe = 0.5 + 0.5 * torch.sin(17.0 * theta)
        ring_rgb = torch.stack([stripe, 1.0 - stripe, torch.full_like(stripe, 0.85)], dim=-1)
        w_ring = (s_ring / (sigma + s_ring + 1e-8))[..., None]
        rgb = rgb * (1.0 - w_ring) + ring_rgb * w_ring
        sigma = sigma + s_ring
    return rgb, sigma


def orbit_poses(n: int, radius: float = 3.0, elevation: float = 0.35,
                phase: float = 0.0) -> torch.Tensor:
    """n world->cam poses on a circular orbit looking at the origin."""
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False) + phase
    poses = []
    for a in angles:
        cam = np.array([radius * np.cos(a), radius * np.sin(a),
                        radius * np.sin(elevation)])
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1).T    # world->cam
        poses.append(np.concatenate([R, (-R @ cam)[:, None]], axis=1))
    return torch.tensor(np.stack(poses), dtype=torch.float32)


def render_analytic(pose: torch.Tensor, intr: torch.Tensor, H: int, W: int,
                    depth_range=(1.5, 4.5), n_samples: int = 192,
                    bg_color: float = 1.0, field: Optional[Callable] = None
                    ) -> torch.Tensor:
    """Ground-truth render of an analytic field (default: the two blobs)
    from one camera, on pose's device."""
    field = field or analytic_field
    center, ray = rays_lib.get_center_and_ray(pose[None], intr[None], H, W)
    depth = torch.linspace(depth_range[0], depth_range[1], n_samples, device=pose.device)
    depth = depth[None, None, :, None].expand(1, H * W, n_samples, 1)
    points = center[..., None, :] + ray[..., None, :] * depth
    rgb_s, sigma_s = field(points)
    rgb, _, _, _ = composite_nerf(ray, rgb_s, sigma_s, depth,
                                  bg_color=torch.full((3,), bg_color, device=pose.device))
    return rgb.reshape(H, W, 3)


def _intrinsics(n_views: int, H: int, W: int, f: float) -> torch.Tensor:
    return torch.tensor([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]],
                        dtype=torch.float32).expand(n_views, 3, 3)


def make_scene(n_views: int = 6, H: int = 32, W: int = 32,
               focal_factor: float = 1.2, depth_range=(1.5, 4.5),
               textured: bool = False) -> SyntheticScene:
    poses = orbit_poses(n_views)
    intr = _intrinsics(n_views, H, W, focal_factor * W)
    field = analytic_field_textured if textured else analytic_field
    images = torch.stack([render_analytic(poses[i], intr[i], H, W, depth_range, field=field)
                          for i in range(n_views)])
    return SyntheticScene(images=images, poses=poses, intr=intr, H=H, W=W,
                          depth_range=depth_range)


def _render_in_strips(poses: torch.Tensor, intr: torch.Tensor, H: int, W: int,
                      depth_range, n_samples: int, chunk_rows: int, field: Callable,
                      device) -> torch.Tensor:
    """Every view rendered in strips of chunk_rows rows (the principal
    point shifted by the strip's first row), on ``device``; [N, H, W, 3] on
    the CPU."""
    images = []
    for i in range(poses.shape[0]):
        strips = []
        for row0 in range(0, H, chunk_rows):
            intr_s = intr[i].clone()
            intr_s[1, 2] -= float(row0)
            strips.append(render_analytic(poses[i].to(device), intr_s.to(device), chunk_rows, W,
                                          depth_range, n_samples=n_samples, field=field))
        # the last strip overruns when H % chunk_rows != 0: trim to H rows
        images.append(torch.cat(strips, dim=0)[:H].cpu())
    return torch.stack(images)


def make_detail_scene(n_views: int = 36, H: int = 256, W: int = 256,
                      focal_factor: Optional[float] = None, outer: bool = False,
                      n_samples: int = 512, chunk_rows: int = 32,
                      device=None) -> SyntheticScene:
    """The detail scene at quality-run scale: three elevation rings of
    views with staggered azimuths; ``outer`` adds the out-of-box torus (and
    a wider default field of view)."""
    if focal_factor is None:
        focal_factor = 1.2 if outer else 2.0
    depth_range = (1.0, 5.0) if outer else (1.5, 4.5)
    rings = [0.1, 0.45, 0.8]
    per = [n_views // 3 + (1 if i < n_views % 3 else 0) for i in range(3)]
    poses = torch.cat([orbit_poses(per[i], elevation=rings[i], phase=i * 0.7)
                       for i in range(3) if per[i] > 0])
    intr = _intrinsics(n_views, H, W, focal_factor * W)
    images = _render_in_strips(poses, intr, H, W, depth_range, n_samples, chunk_rows,
                               lambda p: analytic_field_detail(p, outer=outer), device)
    return SyntheticScene(images=images, poses=poses, intr=intr, H=H, W=W,
                          depth_range=depth_range)


def make_cascade_scene(n_views: int = 72, H: int = 256, W: int = 256,
                       n_samples: int = 512, chunk_rows: int = 32,
                       device=None) -> SyntheticScene:
    """Content inside and outside the unit box (the detail sphere and the
    torus at world radius 1.9), seen from four rings (two elevations at
    each of two radii), for aabb_scale 4 training. n_views divides by 4."""
    rings = [(2.6, 0.15), (2.6, 0.55), (4.2, 0.15), (4.2, 0.55)]
    per = n_views // len(rings)
    if per * len(rings) != n_views:
        raise ValueError("n_views must divide by 4 rings")
    poses = torch.cat([orbit_poses(per, radius=r, elevation=e, phase=i * 0.45)
                       for i, (r, e) in enumerate(rings)])
    intr = _intrinsics(n_views, H, W, 1.0 * W)
    depth_range = (0.6, 6.6)  # radius-4.2 cameras: the torus's far side at ~6.3
    images = _render_in_strips(poses, intr, H, W, depth_range, n_samples, chunk_rows,
                               lambda p: analytic_field_detail(p, outer=True), device)
    return SyntheticScene(images=images, poses=poses, intr=intr, H=H, W=W,
                          depth_range=depth_range)


# synthetic scenes: world -> NGP box, t * SCALE + OFF
SCALE, OFF = 0.33, 0.5


class SyntheticNGPData:
    """A synthetic scene's first ``n_train`` views as NGP training data
    (the JAX run_net's SyntheticNGPData): per-pixel NGP-space rays, and
    targets already composited over white, so training pins that
    background (``fixed_bg``)."""

    fixed_bg = (1.0, 1.0, 1.0)

    def __init__(self, scene: SyntheticScene, n_train: int):
        H, W = scene.H, scene.W
        self.n_images = n_train
        self.n_pixels = H * W
        self.images = scene.images[:n_train].numpy()
        self.focal = float(scene.intr[0, 0, 0])
        c, r = rays_lib.get_center_and_ray(scene.poses[:n_train],
                                           scene.intr[:n_train], H, W)
        d = r / torch.linalg.norm(r, dim=-1, keepdim=True)
        self._o = (c * SCALE + OFF).reshape(n_train, -1, 3).numpy()
        self._d = d.reshape(n_train, -1, 3).numpy()

    def rays_for_pixels(self, img_ids, pix_ids):
        return self._o[img_ids, pix_ids], self._d[img_ids, pix_ids]

    def pixel_values(self, img_ids, pix_ids, bg=None):
        return self.images.reshape(self.n_images, -1, 3)[img_ids, pix_ids]
