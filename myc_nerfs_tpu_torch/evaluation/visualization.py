"""Depth colormaps, image tiling and videos (counterpart of the parts of
myc_nerfs_tpu/evaluation/visualization.py that TensoRF's evaluation calls;
tensorf utils.py:11-54, barf util_vis.py:15-27, renderer.py:134-135).

Numpy only. The JET colormap is computed here (the piecewise-linear jet,
within one 8-bit level of cv2.COLORMAP_JET), so no cv2 is needed; videos
need cv2, and without it ``write_video`` writes the frames as PNGs (PIL)
or, without PIL too, as .npy files, and says so.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import log


def jet(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> JET rgb in [0, 1] (MATLAB's jet, as cv2's)."""
    x = np.asarray(x, np.float64)[..., None]
    return np.clip(1.5 - np.abs(4.0 * x - np.asarray([3.0, 2.0, 1.0])), 0.0, 1.0)


def visualize_depth(depth: np.ndarray, minmax: Optional[Tuple[float, float]] = None):
    """Depth [H, W] -> JET colormap [H, W, 3] float32 in [0, 1], and (mi, ma)."""
    x = np.nan_to_num(np.asarray(depth))
    if minmax is None:
        pos = x[x > 0]
        mi = float(pos.min()) if pos.size else 0.0
        ma = float(x.max())
    else:
        mi, ma = minmax
    xn = ((x - mi) / (ma - mi + 1e-8) * 255).astype(np.uint8)
    colored = np.floor(jet(xn / 255.0) * 255.0 + 0.5).astype(np.uint8)
    return colored.astype(np.float32) / 255.0, (mi, ma)


def tile_images(images: Sequence[np.ndarray], cols: int = 4) -> np.ndarray:
    """Tile [N, H, W, C] into one image, row by row (util_vis.py:15-27)."""
    images = np.asarray(images)
    n, H, W, C = images.shape
    rows = (n + cols - 1) // cols
    canvas = np.zeros((rows * H, cols * W, C), images.dtype)
    for i in range(n):
        r, c = divmod(i, cols)
        canvas[r * H:(r + 1) * H, c * W:(c + 1) * W] = images[i]
    return canvas


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 30) -> Optional[str]:
    """Write an mp4 through cv2; returns its path, or None when no encoder is
    available, after dumping the frames to ``<path without extension>/``
    (PNG with PIL, else .npy) and logging which."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        return None
    u8 = [f if f.dtype == np.uint8 else (np.clip(f, 0, 1) * 255).astype(np.uint8)
          for f in frames]
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        H, W = u8[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
        if vw.isOpened():
            for f in u8:
                vw.write(f[..., ::-1])
            vw.release()
            if os.path.exists(path) and os.path.getsize(path) > 0:
                return path
    base = os.path.splitext(path)[0]
    os.makedirs(base, exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        for i, f in enumerate(u8):
            np.save(os.path.join(base, f"{i:04d}.npy"), f)
        log.warning(f"no video encoder (cv2) and no PIL: {len(u8)} frames as .npy in {base}/")
        return None
    for i, f in enumerate(u8):
        Image.fromarray(f).save(os.path.join(base, f"{i:04d}.png"))
    log.warning(f"no video encoder (cv2): {len(u8)} frames as PNG in {base}/")
    return None
