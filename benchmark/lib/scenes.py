"""The benchmark's synthetic scenes: closed-form emissive fields rendered
from orbit cameras on the device, the inputs both the program and the
reference are handed.

A frozen copy of the port's data/synthetic.py fields and its ground-truth
quadrature, so that the inputs stay the same whatever the program becomes.
Cameras are camera-to-world [3, 4] with +z forward, y down, x right.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch


def detail_field(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An opaque sphere with a displaced, three-octave textured surface and
    a textured torus at world radius 1.9 (the port's analytic_field_detail
    with ``outer``): (rgb [..., 3], sigma [...])."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = torch.linalg.norm(points, dim=-1)
    theta = torch.atan2(y, x)
    phi = torch.arccos(torch.clamp(z / torch.clamp_min(r, 1e-6), -1.0, 1.0))
    disp = (0.05 * torch.sin(7.0 * theta) * torch.sin(5.0 * phi + 1.3)
            + 0.02 * torch.sin(19.0 * theta + 2.1) * torch.sin(13.0 * phi)
            + 0.008 * torch.sin(41.0 * theta) * torch.sin(37.0 * phi + 0.7))
    sigma = 60.0 * torch.sigmoid((0.48 + disp - r) * 150.0)
    t1 = torch.sin(23.0 * x + 31.0 * y) * torch.sin(27.0 * z - 17.0 * x)
    t2 = torch.sin(71.0 * x - 53.0 * z + 1.0) * torch.sin(61.0 * y + 0.5)
    t3 = torch.sin(181.0 * x + 167.0 * y + 149.0 * z)
    red = torch.clamp(0.55 + 0.28 * t1 + 0.13 * t2 + 0.06 * t3, 0.0, 1.0)
    grn = torch.clamp(0.45 + 0.24 * torch.sin(2.0 * theta + 4.0 * phi)
                      + 0.18 * t2 - 0.08 * t3, 0.0, 1.0)
    blu = torch.clamp(0.50 - 0.22 * t1 + 0.20 * torch.sin(43.0 * y + 29.0 * z)
                      * torch.sin(37.0 * x), 0.0, 1.0)
    rgb = torch.stack([red, grn, blu], dim=-1)
    dring = torch.sqrt((torch.sqrt(x ** 2 + y ** 2) - 1.9) ** 2 + (z - 0.2) ** 2)
    s_ring = 80.0 * torch.sigmoid((0.16 - dring) * 120.0)
    stripe = 0.5 + 0.5 * torch.sin(17.0 * theta)
    ring_rgb = torch.stack([stripe, 1.0 - stripe, torch.full_like(stripe, 0.85)], dim=-1)
    w_ring = (s_ring / (sigma + s_ring + 1e-8))[..., None]
    return rgb * (1.0 - w_ring) + ring_rgb * w_ring, sigma + s_ring


def ellipsoid_field(center: Sequence[float], radii: Sequence[float]) -> Callable:
    """A dense textured ellipsoid: (rgb [..., 3], sigma [...])."""
    def field(points: torch.Tensor):
        c = torch.tensor(center, dtype=points.dtype, device=points.device)
        rad = torch.tensor(radii, dtype=points.dtype, device=points.device)
        q = (points - c) / rad
        r = torch.linalg.norm(q, dim=-1)
        sigma = 80.0 * torch.sigmoid((1.0 - r) * 40.0)
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        rgb = torch.stack([0.5 + 0.4 * torch.sin(31.0 * x + 7.0 * z),
                           0.5 + 0.4 * torch.sin(23.0 * y) * torch.cos(11.0 * z),
                           0.5 + 0.4 * torch.cos(19.0 * z - 5.0 * x)], dim=-1)
        return rgb, sigma
    return field


def orbit(n: int, radius: float, elevation: float, phase: float,
          center: Sequence[float] = (0.0, 0.0, 0.0)) -> torch.Tensor:
    """n cameras [n, 3, 4] on a circle around ``center`` looking at it."""
    cams = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False) + phase:
        pos = np.array([radius * np.cos(a), radius * np.sin(a),
                        radius * np.sin(elevation)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        cams.append(np.concatenate([np.stack([right, down, fwd], 1),
                                    (pos + np.asarray(center))[:, None]], 1))
    return torch.tensor(np.stack(cams), dtype=torch.float32)


def pixel_rays(c2w: torch.Tensor, H: int, W: int, focal: float, row0: int = 0,
               rows: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and unnormalised directions (camera z = 1) [rows * W, 3] of
    the pixel centres of rows row0 .. row0 + rows of one camera."""
    rows = rows or H
    dev = c2w.device
    j = torch.arange(row0, row0 + rows, dtype=torch.float32, device=dev) + 0.5
    i = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    cam = torch.stack([(ii - W / 2.0) / focal, (jj - H / 2.0) / focal,
                       torch.ones_like(ii)], -1).reshape(-1, 3)
    d = cam @ c2w[:, :3].t()
    return c2w[:, 3].expand(d.shape), d


@torch.no_grad()
def render(field: Callable, c2w: torch.Tensor, H: int, W: int, focal: float,
           depth_range: Tuple[float, float], n_samples: int, rows: int = 64,
           white: float = 1.0) -> torch.Tensor:
    """Ground truth [H, W, 3] of ``field`` from one camera: n_samples depths
    per ray, the NeRF quadrature, a white background; row strips."""
    out = []
    depth = torch.linspace(depth_range[0], depth_range[1], n_samples, device=c2w.device)
    for row0 in range(0, H, rows):
        n = min(rows, H - row0)
        o, d = pixel_rays(c2w, H, W, focal, row0, n)
        pts = o[:, None, :] + d[:, None, :] * depth[None, :, None]
        rgb_s, sigma = field(pts)
        intv = torch.cat([depth[1:] - depth[:-1], depth.new_full((1,), 1e10)])
        sd = sigma * intv[None, :] * torch.linalg.norm(d, dim=-1, keepdim=True)
        excl = torch.cumsum(torch.cat([torch.zeros_like(sd[:, :1]), sd[:, :-1]], -1), -1)
        w = torch.exp(-excl) * (1.0 - torch.exp(-sd))
        rgb = (rgb_s * w[..., None]).sum(1) + white * (1.0 - w.sum(1, keepdim=True))
        out.append(rgb)
    return torch.cat(out).reshape(H, W, 3)
