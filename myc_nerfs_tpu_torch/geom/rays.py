"""Ray generation (counterpart of myc_nerfs_tpu/geom/rays.py).

Half-pixel-centre pixel grid (barf camera.py:234-252), per-pixel
camera-frame directions and their world rays (tensorf ray_utils.py:81-153),
the NDC projection and points along rays (barf camera.py:254-277).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .pose import cam2world, img2cam, to_hom


def pixel_grid(H: int, W: int, offset: float = 0.5, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """[H*W, 2] (x, y) pixel-centre coordinates."""
    y = torch.arange(H, dtype=dtype, device=device) + offset
    x = torch.arange(W, dtype=dtype, device=device) + offset
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def get_center_and_ray(pose: torch.Tensor, intr: torch.Tensor, H: int, W: int,
                       xy_grid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera centres + (unnormalised) world-frame ray directions.

    pose: [B, 3, 4] world->cam; intr: [B, 3, 3]. Returns ([B, N, 3], [B, N, 3]).
    """
    if xy_grid is None:
        xy_grid = pixel_grid(H, W, dtype=pose.dtype, device=pose.device)
    B = pose.shape[0]
    xy = xy_grid[None].expand((B,) + xy_grid.shape)
    grid_3d = img2cam(to_hom(xy), intr)
    center_3d = cam2world(torch.zeros_like(grid_3d), pose)
    grid_3d = cam2world(grid_3d, pose)
    return center_3d, grid_3d - center_3d


def get_ray_directions(H: int, W: int, focal, center=None,
                       device=None) -> torch.Tensor:
    """Per-pixel camera-frame ray directions [H, W, 3], OpenCV-style (+z
    forward, y down). ``focal``/``center`` entries may be floats or 0-dim
    tensors."""
    if isinstance(focal, (tuple, list)):
        fx, fy = focal
    else:
        fx = fy = focal
    cx, cy = (W / 2.0, H / 2.0) if center is None else (center[0], center[1])
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    return torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                       dim=-1)


def get_rays_from_directions(directions: torch.Tensor, c2w: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame directions [..., 3] rotated by c2w [3, 4]: (origins
    [M, 3], unit directions [M, 3]) (tensorf ray_utils.py:132-153)."""
    rays_d = directions @ c2w[:3, :3].t()
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def convert_ndc(center: torch.Tensor, ray: torch.Tensor, intr: torch.Tensor,
                near: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins moved to the near plane, then origins and directions
    projected to NDC (cameras facing +z; camera.py:260-277). center, ray
    [B, N, 3]; intr [B, 3, 3]."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = (intr[:, 0, 0] / intr[:, 0, 2])[:, None]
    scale_y = (intr[:, 1, 1] / intr[:, 1, 2])[:, None]
    center_ndc = torch.stack([scale_x * (cx / cz), scale_y * (cy / cz),
                              1.0 - 2.0 * near / cz], dim=-1)
    ray_ndc = torch.stack([scale_x * (rx / rz - cx / cz), scale_y * (ry / rz - cy / cz),
                           2.0 * near / cz], dim=-1)
    return center_ndc, ray_ndc


def points_from_depth(center: torch.Tensor, ray: torch.Tensor, depth: torch.Tensor,
                      multi_samples: bool = False) -> torch.Tensor:
    """x = c + d v (camera.py:254-258); with ``multi_samples`` depth
    [..., S, 1] gives S points per ray."""
    if multi_samples:
        center, ray = center[..., None, :], ray[..., None, :]
    return center + ray * depth
