"""Synthetic multi-view scenes (counterpart of myc_nerfs_tpu/data/synthetic.py).

Ground-truth images of a closed-form emissive field, volume-rendered at a
high sample count from orbit cameras: the data of run_net's ``--synthetic``
mode. Only ``make_scene`` (and what it calls) is ported.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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
                    bg_color: float = 1.0) -> torch.Tensor:
    """Ground-truth render of the analytic field from one camera."""
    center, ray = rays_lib.get_center_and_ray(pose[None], intr[None], H, W)
    depth = torch.linspace(depth_range[0], depth_range[1], n_samples)
    depth = depth[None, None, :, None].expand(1, H * W, n_samples, 1)
    points = center[..., None, :] + ray[..., None, :] * depth
    rgb_s, sigma_s = analytic_field(points)
    rgb, _, _, _ = composite_nerf(ray, rgb_s, sigma_s, depth,
                                  bg_color=torch.full((3,), bg_color))
    return rgb.reshape(H, W, 3)


def make_scene(n_views: int = 6, H: int = 32, W: int = 32,
               focal_factor: float = 1.2, depth_range=(1.5, 4.5)
               ) -> SyntheticScene:
    poses = orbit_poses(n_views)
    f = focal_factor * W
    intr = torch.tensor([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]],
                        dtype=torch.float32).expand(n_views, 3, 3)
    images = torch.stack([render_analytic(poses[i], intr[i], H, W, depth_range)
                          for i in range(n_views)])
    return SyntheticScene(images=images, poses=poses, intr=intr, H=H, W=W,
                          depth_range=depth_range)
