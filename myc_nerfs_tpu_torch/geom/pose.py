"""Camera-pose [R|t] helpers on [..., 3, 4] tensors (world->camera).

Counterpart of myc_nerfs_tpu/geom/pose.py, carrying only what ray
generation needs.
"""
from __future__ import annotations

import torch


def to_hom(X: torch.Tensor) -> torch.Tensor:
    """Append homogeneous 1."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Invert [R|t]: (R^T | -R^T t)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return torch.cat([R_inv, -R_inv @ t], dim=-1)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] camera points -> world frame."""
    return to_hom(X) @ invert_pose(pose).transpose(-1, -2)


def img2cam(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Homogeneous pixels -> camera rays via K^-1."""
    return X @ torch.linalg.inv(intr).transpose(-1, -2)
