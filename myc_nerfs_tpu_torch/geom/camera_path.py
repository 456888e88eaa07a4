"""Demo camera paths (spherical orbit), numpy only.

Counterpart of myc_nerfs_tpu/geom/camera_path.py (jnerf
dataset/camera_path.py:4-28).
"""
from __future__ import annotations

from typing import List

import numpy as np


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w [3, 4] on a sphere, NeRF convention."""
    def trans_t(t):
        m = np.eye(4, dtype=np.float32)
        m[2, 3] = t
        return m

    def rot_phi(p):
        m = np.eye(4, dtype=np.float32)
        m[1, 1] = np.cos(p); m[1, 2] = -np.sin(p)
        m[2, 1] = np.sin(p); m[2, 2] = np.cos(p)
        return m

    def rot_theta(th):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = np.cos(th); m[0, 2] = -np.sin(th)
        m[2, 0] = np.sin(th); m[2, 2] = np.cos(th)
        return m

    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.asarray([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                     np.float32) @ c2w
    return c2w[:-1, :]


def path_spherical(nframe: int = 80, phi: float = -30.0,
                   radius: float = 4.0) -> List[np.ndarray]:
    """Orbit path (camera_path.py:27-28)."""
    return [pose_spherical(a, phi, radius)
            for a in np.linspace(-180, 180, nframe + 1)[:-1]]
