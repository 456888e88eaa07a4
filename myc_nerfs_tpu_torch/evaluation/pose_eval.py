"""Camera-pose alignment evaluation for BARF/GARF (counterpart of
myc_nerfs_tpu/evaluation/pose_eval.py; barf garf.py:136-158).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geom import pose as pose_lib
from ..geom.procrustes import Sim3, apply_sim3, procrustes_analysis


class PoseError(NamedTuple):
    R: torch.Tensor  # [N] rotation geodesic errors (radians)
    t: torch.Tensor  # [N] translation errors


def camera_centers(poses: torch.Tensor) -> torch.Tensor:
    """World-frame camera centres of world->cam poses [N, 3, 4] -> [N, 3]."""
    return (-poses[..., :3].transpose(-1, -2) @ poses[..., 3:])[..., 0]


def prealign_cameras(pose: torch.Tensor, pose_GT: torch.Tensor) -> Tuple[torch.Tensor, Sim3]:
    """Procrustes-align predicted cameras onto the ground truth's
    (garf.py:136-148)."""
    center_pred = camera_centers(pose)
    sim3 = procrustes_analysis(camera_centers(pose_GT), center_pred)
    center_aligned = apply_sim3(sim3, center_pred)
    R_aligned = pose[..., :3] @ sim3.R.T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return pose_lib.make_pose(R=R_aligned, t=t_aligned), sim3


def evaluate_camera_alignment(pose_aligned: torch.Tensor, pose_GT: torch.Tensor) -> PoseError:
    """Rotation and translation errors between aligned and ground-truth poses
    (garf.py:150-158)."""
    return PoseError(R=pose_lib.rotation_distance(pose_aligned[..., :3], pose_GT[..., :3]),
                     t=torch.linalg.norm(pose_aligned[..., 3] - pose_GT[..., 3], dim=-1))
