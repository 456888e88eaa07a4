"""Quaternion <-> rotation matrix (counterpart of
myc_nerfs_tpu/geom/quaternion.py; barf camera.py:142-191).

Quaternions are [..., 4] (w, x, y, z). ``R_to_q`` is branch-free: Shepperd's
method picks, per element, the largest of the four candidate denominators,
each under a square root clamped at eps, in place of the reference's
eigen-decomposition fallback for NaNs (camera.py:166-176).
"""
from __future__ import annotations

import torch

__all__ = ["q_to_R", "R_to_q", "q_invert", "q_product"]


def q_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation [..., 3, 3]."""
    qa, qb, qc, qd = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], -1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                     2 * (qc * qd - qa * qb)], -1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb ** 2 + qc ** 2)], -1),
    ], dim=-2)


def R_to_q(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] with w >= 0."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = R00 + R11 + R22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, eps))

    r0 = safe_sqrt(1.0 + tr)
    q0 = torch.stack([0.5 * r0, (R21 - R12) / (2 * r0), (R02 - R20) / (2 * r0),
                      (R10 - R01) / (2 * r0)], -1)
    r1 = safe_sqrt(1.0 + R00 - R11 - R22)
    q1 = torch.stack([(R21 - R12) / (2 * r1), 0.5 * r1, (R01 + R10) / (2 * r1),
                      (R02 + R20) / (2 * r1)], -1)
    r2 = safe_sqrt(1.0 - R00 + R11 - R22)
    q2 = torch.stack([(R02 - R20) / (2 * r2), (R01 + R10) / (2 * r2), 0.5 * r2,
                      (R12 + R21) / (2 * r2)], -1)
    r3 = safe_sqrt(1.0 - R00 - R11 + R22)
    q3 = torch.stack([(R10 - R01) / (2 * r3), (R02 + R20) / (2 * r3),
                      (R12 + R21) / (2 * r3), 0.5 * r3], -1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)                 # [..., 4, 4]
    idx = torch.stack([tr, R00, R11, R22], dim=-1).argmax(-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def q_invert(q: torch.Tensor) -> torch.Tensor:
    """Quaternion inverse (camera.py:178-182)."""
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return conj / (q ** 2).sum(-1, keepdim=True)


def q_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product (camera.py:184-191)."""
    a1, b1, c1, d1 = q1.unbind(-1)
    a2, b2, c2, d2 = q2.unbind(-1)
    return torch.stack([a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
                        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
                        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
                        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2], dim=-1)
