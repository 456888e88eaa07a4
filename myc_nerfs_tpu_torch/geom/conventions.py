"""Camera-pose conventions (counterpart of myc_nerfs_tpu/geom/conventions.py).

- NGP: per-axis sign flips (correct_pose), t*scale+offset, row cycle
  [1, 2, 0] (jnerf dataset.py:313-320), for the blender loader;
- BARF, back from world->cam [3, 4] to Blender c2w for the pose export
  (the parse is data/blender.py::barf_views);
- TensoRF: Blender c2w to OpenCV axes (blender2opencv).
"""
from __future__ import annotations

import numpy as np
import torch

from .pose import compose_pair, invert_pose, make_pose

NERF_SCALE = 0.33  # jnerf dataset.py: global scene scale applied to t


def matrix_nerf2ngp(matrix, scale, offset, correct_pose=(1, -1, -1)) -> np.ndarray:
    """NeRF c2w [3|4, 4] -> the NGP layout [3, 4], in float32: column sign
    flips by correct_pose, translation * scale + offset, rows cycled."""
    m = np.asarray(matrix, np.float32)[:3, :]
    cp = np.asarray(correct_pose, np.float32)
    m = m * np.concatenate([cp, np.ones((1,), np.float32)])[None, :]
    m[:, 3] = m[:, 3] * np.float32(scale) + np.asarray(offset, np.float32)
    return m[[1, 2, 0]]


def unparse_camera_barf(pose: torch.Tensor) -> torch.Tensor:
    """BARF world->cam [..., 3, 4] -> Blender c2w rows [..., 3, 4]:
    flip(diag(-1, -1, 1)) o invert(pose), the inverse of the parse in
    data/blender.py::barf_views (the pose export, barf.py:167-202)."""
    flip = torch.diag(torch.tensor([-1.0, -1.0, 1.0], dtype=pose.dtype, device=pose.device))
    return compose_pair(make_pose(R=flip).expand(pose.shape[:-2] + (3, 4)), invert_pose(pose))


def blender2opencv(c2w_blender: torch.Tensor) -> torch.Tensor:
    """TensoRF's convention: c2w @ diag(1, -1, -1, 1) (dataLoader/blender.py:33,91)."""
    b2cv = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=c2w_blender.dtype,
                                   device=c2w_blender.device))
    return c2w_blender @ b2cv
