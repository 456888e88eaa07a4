"""Procrustes sim(3) alignment of camera centres (counterpart of
myc_nerfs_tpu/geom/procrustes.py; barf camera.py:286-306), for BARF/GARF
pose evaluation and test-pose transfer. The reflection fix is a
``torch.where`` on the sign of det(R), with no branch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pose import make_pose

__all__ = ["Sim3", "procrustes_analysis", "apply_sim3", "align_poses_sim3"]


class Sim3(NamedTuple):
    t0: torch.Tensor  # [3] centroid of X0
    t1: torch.Tensor  # [3] centroid of X1
    s0: torch.Tensor  # scale of X0
    s1: torch.Tensor  # scale of X1
    R: torch.Tensor   # [3, 3] rotation from X1's frame to X0's


def procrustes_analysis(X0: torch.Tensor, X1: torch.Tensor) -> Sim3:
    """The similarity that aligns point set X1 [N, 3] onto X0 [N, 3]:
    X1to0 = (X1 - t1) / s1 @ R^T * s0 + t0."""
    t0, t1 = X0.mean(dim=0), X1.mean(dim=0)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c ** 2).sum(dim=-1).mean())
    U, _, Vh = torch.linalg.svd((X0c / s0).T @ (X1c / s1))
    R = U @ Vh
    flip = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0).to(R.dtype)
    R = torch.cat([R[:2], R[2:] * flip], dim=0)
    return Sim3(t0=t0, t1=t1, s0=s0, s1=s1, R=R)


def apply_sim3(sim3: Sim3, X1: torch.Tensor) -> torch.Tensor:
    """Points [N, 3] from X1's frame into X0's frame."""
    return (X1 - sim3.t1) / sim3.s1 @ sim3.R.T * sim3.s0 + sim3.t0


def align_poses_sim3(sim3: Sim3, poses: torch.Tensor) -> torch.Tensor:
    """World->cam poses [N, 3, 4] aligned by the sim3 found on their camera
    centres: centres mapped, rotations composed with R (barf.py:130-142)."""
    R_c2w = poses[..., :3].transpose(-1, -2)
    centers = (-R_c2w @ poses[..., 3:])[..., 0]
    centers_aligned = apply_sim3(sim3, centers)
    R_aligned = poses[..., :3] @ sim3.R.T[None]
    t_aligned = (-R_aligned @ centers_aligned[..., None])[..., 0]
    return make_pose(R=R_aligned, t=t_aligned)
