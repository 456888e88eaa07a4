"""Planar warps: SO(2), SE(2) and SL(3) exp and log maps, pixel grids and
grid warps (counterpart of myc_nerfs_tpu/geom/warp2d.py; barf
warp.py:10-169, the planar-alignment library).
"""
from __future__ import annotations

import torch

from .pose import to_hom

__all__ = ["so2_to_SO2", "SO2_to_so2", "se2_to_SE2", "SE2_to_se2",
           "sl3_to_SL3", "warp_grid", "normalized_pixel_grid",
           "normalized_pixel_grid_crop", "warp_corners",
           "check_corners_in_range"]


def _taylor_A(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """sin(x)/x (warp.py:151-157)."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        if i > 0:
            denom *= (2 * i) * (2 * i + 1)
        ans = ans + (-1.0) ** i * x ** (2 * i) / denom
    return ans


def _taylor_B(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """(1-cos(x))/x (warp.py:158-164: /x, not /x^2)."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= (2 * i + 1) * (2 * i + 2)
        ans = ans + (-1.0) ** i * x ** (2 * i + 1) / denom
    return ans


def so2_to_SO2(theta: torch.Tensor) -> torch.Tensor:
    """[..., 1] -> [..., 2, 2] (warp.py:122-126)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.cat([c, -s], -1), torch.cat([s, c], -1)], -2)


def SO2_to_so2(R: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2] -> [..., 1] (warp.py:128-130)."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])[..., None]


def se2_to_SE2(delta: torch.Tensor) -> torch.Tensor:
    """[..., 3] (u, theta) -> [..., 2, 3] = [R | V u] (warp.py:139-147)."""
    u, theta = delta[..., :2], delta[..., 2:]
    A, B = _taylor_A(theta), _taylor_B(theta)
    V = torch.stack([torch.cat([A, -B], -1), torch.cat([B, A], -1)], -2)
    return torch.cat([so2_to_SO2(theta), V @ u[..., None]], -1)


def SE2_to_se2(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse of se2_to_SE2: [..., 2, 3] -> [..., 3]."""
    R, t = Rt[..., :2], Rt[..., 2:]
    theta = SO2_to_so2(R)
    A, B = _taylor_A(theta), _taylor_B(theta)
    denom = A ** 2 + B ** 2 + eps
    invV = torch.stack([torch.cat([A, B], -1), torch.cat([-B, A], -1)], -2) / denom[..., None]
    return torch.cat([(invV @ t)[..., 0], theta], -1)


def sl3_to_SL3(h: torch.Tensor) -> torch.Tensor:
    """[..., 8] -> homography [..., 3, 3], the matrix exponential of the
    traceless generator (warp.py:133-141)."""
    h1, h2, h3, h4, h5, h6, h7, h8 = h.split(1, dim=-1)
    A = torch.stack([torch.cat([h5, h3, h1], -1),
                     torch.cat([h4, -h5 - h6, h2], -1),
                     torch.cat([h7, h8, h6], -1)], -2)
    return torch.linalg.matrix_exp(A)


def _grid(y: torch.Tensor, x: torch.Tensor, batch: int) -> torch.Tensor:
    Y, X = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([X, Y], -1).reshape(-1, 2)
    return grid[None].expand((batch,) + grid.shape)


def normalized_pixel_grid(H: int, W: int, batch: int = 1, device=None) -> torch.Tensor:
    """[B, H*W, 2] pixel centres in [-1, 1], scaled by the aspect
    (warp.py:10-16)."""
    m = max(H, W)
    y = ((torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H * 2 - 1) * (H / m)
    x = ((torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W * 2 - 1) * (W / m)
    return _grid(y, x, batch)


def normalized_pixel_grid_crop(H: int, W: int, H_crop: int, W_crop: int,
                               batch: int = 1, device=None) -> torch.Tensor:
    """The centre crop's part of normalized_pixel_grid (warp.py:18-26)."""
    m = max(H, W)
    y0, y1 = H // 2 - H_crop // 2, H // 2 + H_crop // 2
    x0, x1 = W // 2 - W_crop // 2, W // 2 + W_crop // 2
    y = ((torch.arange(y0, y1, dtype=torch.float32, device=device) + 0.5) / H * 2 - 1) * (H / m)
    x = ((torch.arange(x0, x1, dtype=torch.float32, device=device) + 0.5) / W * 2 - 1) * (W / m)
    return _grid(y, x, batch)


def warp_grid(xy_grid: torch.Tensor, warp: torch.Tensor, warp_type: str) -> torch.Tensor:
    """A planar warp of [B, N, 2] points (warp.py:28-48)."""
    if warp_type == "translation":
        return xy_grid + warp[..., None, :]
    if warp_type == "rotation":
        return xy_grid @ so2_to_SO2(warp).transpose(-1, -2)
    if warp_type == "rigid":
        return to_hom(xy_grid) @ se2_to_SE2(warp).transpose(-1, -2)
    if warp_type == "homography":
        out = to_hom(xy_grid) @ sl3_to_SL3(warp).transpose(-1, -2)
        return out[..., :2] / (out[..., 2:] + 1e-8)
    raise ValueError(warp_type)


def warp_corners(H: int, W: int, H_crop: int, W_crop: int, warp_param: torch.Tensor,
                 warp_type: str) -> torch.Tensor:
    """The crop's four corners, warped: [B, 4, 2] (warp.py:50-59)."""
    m = max(H, W)
    y_crop = (H // 2 - H_crop // 2, H // 2 + H_crop // 2)
    x_crop = (W // 2 - W_crop // 2, W // 2 + W_crop // 2)
    Y = [((y + 0.5) / H * 2 - 1) * (H / m) for y in y_crop]
    X = [((x + 0.5) / W * 2 - 1) * (W / m) for x in x_crop]
    corners = torch.tensor([(X[0], Y[0]), (X[0], Y[1]), (X[1], Y[1]), (X[1], Y[0])],
                           dtype=warp_param.dtype, device=warp_param.device)
    return warp_grid(corners[None].expand(warp_param.shape[0], 4, 2), warp_param, warp_type)


def check_corners_in_range(H: int, W: int, H_crop: int, W_crop: int,
                           warp_param: torch.Tensor, warp_type: str) -> torch.Tensor:
    """Whether every warped corner lies inside the image (warp.py:61-66)."""
    m = max(H, W)
    c = warp_corners(H, W, H_crop, W_crop, warp_param, warp_type)
    X = (c[..., 0] / W * m + 1) / 2 * W - 0.5
    Y = (c[..., 1] / H * m + 1) / 2 * H - 0.5
    return ((0 <= X) & (X < W) & (0 <= Y) & (Y < H)).all()
