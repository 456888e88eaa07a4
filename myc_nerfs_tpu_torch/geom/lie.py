"""SO(3)/SE(3) exp and log maps (counterpart of myc_nerfs_tpu/geom/lie.py).

The BARF camera algebra (barf camera.py:61-140) on batched tensors
``[..., 3]`` / ``[..., 3, 3]`` / ``[..., 3, 4]``. The coefficients sin(x)/x,
(1-cos(x))/x^2 and (x-sin(x))/x^3 are Taylor series in theta^2 (nth = 10),
taken straight from w.w: no norm, no division by theta. So the gradient at
theta = 0, where every pose correction starts, is exact and finite; a
sin(theta)/theta form, or a norm before the series, gives NaN there.
"""
from __future__ import annotations

import math

import torch

__all__ = ["skew", "taylor_A", "so3_to_SO3", "SO3_to_so3", "se3_to_SE3", "SE3_to_se3"]


def skew(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of w [..., 3] -> [..., 3, 3]."""
    w0, w1, w2 = w.unbind(-1)
    O = torch.zeros_like(w0)
    return torch.stack([torch.stack([O, -w2, w1], dim=-1),
                        torch.stack([w2, O, -w0], dim=-1),
                        torch.stack([-w1, w0, O], dim=-1)], dim=-2)


def _taylor_series_sq(x2: torch.Tensor, denom_step, nth: int) -> torch.Tensor:
    """sum_i (-1)^i (x^2)^i / denom(i), i = 0..nth, from x^2 directly."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    xp = torch.ones_like(x2)
    for i in range(nth + 1):
        denom = denom_step(denom, i)
        ans = ans + ((-1.0) ** i) * xp / denom
        xp = xp * x2
    return ans


def _A_sq(x2, nth=10):  # sin(x)/x of x2 = x^2
    return _taylor_series_sq(x2, lambda d, i: d * (2 * i) * (2 * i + 1) if i > 0 else d, nth)


def _B_sq(x2, nth=10):  # (1-cos(x))/x^2
    return _taylor_series_sq(x2, lambda d, i: d * (2 * i + 1) * (2 * i + 2), nth)


def _C_sq(x2, nth=10):  # (x-sin(x))/x^3
    return _taylor_series_sq(x2, lambda d, i: d * (2 * i + 2) * (2 * i + 3), nth)


def taylor_A(x: torch.Tensor, nth: int = 10) -> torch.Tensor:
    """sin(x)/x (camera.py:117-124)."""
    return _A_sq(x * x, nth)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """Exp map so(3) -> SO(3): w [..., 3] -> R = I + A [w]_x + B [w]_x^2
    (camera.py:66-73)."""
    wx = skew(w)
    theta2 = (w * w).sum(-1)[..., None, None]
    return _eye(w) + _A_sq(theta2) * wx + _B_sq(theta2) * (wx @ wx)


def SO3_to_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Log map SO(3) -> so(3): R [..., 3, 3] -> w [..., 3] (camera.py:75-81)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps))
    theta = torch.remainder(theta, math.pi)[..., None, None]
    lnR = 1.0 / (2.0 * taylor_A(theta) + 1e-8) * (R - R.transpose(-1, -2))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """Exp map se(3) -> SE(3): wu [..., 6] (rotation w | translation u) ->
    [R | V u] [..., 3, 4], V = I + B [w]_x + C [w]_x^2 (camera.py:83-94)."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    wx2 = wx @ wx
    theta2 = (w * w).sum(-1)[..., None, None]
    I = _eye(wu)
    A, B, C = _A_sq(theta2), _B_sq(theta2), _C_sq(theta2)
    R = I + A * wx + B * wx2
    V = I + B * wx + C * wx2
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log map SE(3) -> se(3): [..., 3, 4] -> [..., 6] (camera.py:96-107)."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew(w)
    theta2 = (w * w).sum(-1)[..., None, None]
    A, B = _A_sq(theta2), _B_sq(theta2)
    invV = _eye(Rt) - 0.5 * wx + (1.0 - A / (2.0 * B)) / (theta2 + eps) * (wx @ wx)
    return torch.cat([w, (invV @ t)[..., 0]], dim=-1)
