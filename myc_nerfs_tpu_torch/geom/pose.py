"""Camera-pose [R|t] algebra on [..., 3, 4] tensors (counterpart of
myc_nerfs_tpu/geom/pose.py; barf camera.py:11-59, 197-232, 279-318).

Poses are world->camera maps x_cam = R x_world + t.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def make_pose(R: Optional[torch.Tensor] = None,
              t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A [..., 3, 4] pose from R [..., 3, 3] and/or t [..., 3]; a missing R
    is the identity, a missing t zeros (camera.py:17-34)."""
    if R is None and t is None:
        raise ValueError("make_pose needs R and/or t")
    if R is None:
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(t.shape[:-1] + (3, 3))
    elif t is None:
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    return torch.cat([R, t[..., None]], dim=-1)


def to_hom(X: torch.Tensor) -> torch.Tensor:
    """Append homogeneous 1."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Invert [R|t]: (R^T | -R^T t)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return torch.cat([R_inv, -R_inv @ t], dim=-1)


def compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b(pose_a(x)) (camera.py:52-59)."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return torch.cat([R_b @ R_a, R_b @ t_a + t_b], dim=-1)


def compose(pose_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """pose_new(x) = poseN(... pose2(pose1(x))) (camera.py:44-50)."""
    pose_new = pose_list[0]
    for p in pose_list[1:]:
        pose_new = compose_pair(pose_new, p)
    return pose_new


def world2cam(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] world points -> camera frame."""
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2world(X: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] camera points -> world frame."""
    return to_hom(X) @ invert_pose(pose).transpose(-1, -2)


def cam2img(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Camera points -> image plane via K."""
    return X @ intr.transpose(-1, -2)


def img2cam(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Homogeneous pixels -> camera rays via K^-1 (inv_ex: no singularity
    check, which would make the host wait for the device)."""
    return X @ torch.linalg.inv_ex(intr)[0].transpose(-1, -2)


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotations (camera.py:279-284)."""
    R_diff = R1 @ R2.transpose(-1, -2)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps))


def angle_to_rotation_matrix(a: torch.Tensor, axis: str) -> torch.Tensor:
    """Rotation about X, Y or Z by the angle(s) a (camera.py:223-232)."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    O, I = torch.zeros_like(a), torch.ones_like(a)
    c, s = torch.cos(a), torch.sin(a)
    M = torch.stack([torch.stack([c, -s, O], dim=-1),
                     torch.stack([s, c, O], dim=-1),
                     torch.stack([O, O, I], dim=-1)], dim=-2)
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def get_novel_view_poses(pose_anchor: torch.Tensor, N: int = 60,
                         scale: float = 1.0) -> torch.Tensor:
    """The circular small-oscillation novel-view path (camera.py:308-318)."""
    kw = dict(dtype=torch.float32, device=pose_anchor.device)
    theta = torch.arange(N, **kw) / N * 2.0 * math.pi
    R_x = angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * 0.05), "X")
    R_y = angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * 0.05), "Y")
    pose_rot = make_pose(R=R_y @ R_x)
    pose_shift = make_pose(t=torch.tensor([0.0, 0.0, -4.0 * scale], **kw))
    pose_shift2 = make_pose(t=torch.tensor([0.0, 0.0, 3.8 * scale], **kw))
    pose_oscil = compose([pose_shift.expand(N, 3, 4), pose_rot,
                          pose_shift2.expand(N, 3, 4)])
    return compose([pose_oscil, pose_anchor[None]])
