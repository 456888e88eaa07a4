"""Camera-pose conventions (counterpart of myc_nerfs_tpu/geom/conventions.py).

Only the NGP one is ported, which the blender loader needs: per-axis sign
flips (correct_pose), t*scale+offset, row cycle [1, 2, 0] (jnerf
dataset.py:313-320).
"""
from __future__ import annotations

import numpy as np

NERF_SCALE = 0.33  # jnerf dataset.py: global scene scale applied to t


def matrix_nerf2ngp(matrix, scale, offset, correct_pose=(1, -1, -1)) -> np.ndarray:
    """NeRF c2w [3|4, 4] -> the NGP layout [3, 4], in float32: column sign
    flips by correct_pose, translation * scale + offset, rows cycled."""
    m = np.asarray(matrix, np.float32)[:3, :]
    cp = np.asarray(correct_pose, np.float32)
    m = m * np.concatenate([cp, np.ones((1,), np.float32)])[None, :]
    m[:, 3] = m[:, 3] * np.float32(scale) + np.asarray(offset, np.float32)
    return m[[1, 2, 0]]
