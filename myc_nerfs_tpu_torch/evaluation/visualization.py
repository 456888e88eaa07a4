"""Depth colormaps, image tiling, camera-pose plots and videos
(counterpart of myc_nerfs_tpu/evaluation/visualization.py; tensorf
utils.py:11-54, barf util_vis.py:15-27,178-250, renderer.py:134-135).

Numpy only at import. The JET colormap is computed here (the
piecewise-linear jet, within one 8-bit level of cv2.COLORMAP_JET), so no
cv2 is needed. The optional packages fall back and say so: videos need cv2,
and without it ``write_video`` writes the frames as PNGs (PIL) or, without
PIL too, as .npy files; pose plots need matplotlib, and without it
``plot_poses`` writes the camera wireframes' vertices as .npy.
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


def save_image(path_stem: str, img: np.ndarray) -> None:
    """img [H, W, 3] in [0, 1] -> <stem>.npy, and <stem>.png where PIL is
    importable."""
    img = np.asarray(img)
    np.save(path_stem + ".npy", img)
    try:
        from PIL import Image
    except ImportError:
        return
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path_stem + ".png")


def _frustum_points(pose_w2c: np.ndarray, depth: float = 0.5) -> np.ndarray:
    """A camera's wireframe in the world frame: its centre, then the four
    corners of its image plane at ``depth`` [5, 3] (util_vis.py's glyph)."""
    pose_w2c = np.asarray(pose_w2c)
    R, t = pose_w2c[:3, :3], pose_w2c[:3, 3]
    center = -R.T @ t
    corners_cam = np.asarray([[-0.5, -0.5, 1], [0.5, -0.5, 1],
                              [0.5, 0.5, 1], [-0.5, 0.5, 1]]) * depth
    return np.concatenate([center[None], corners_cam @ R + center], 0)


def plot_poses(poses: np.ndarray, poses_ref: Optional[np.ndarray] = None,
               path: str = "poses.png", cam_depth: float = 0.5) -> Optional[str]:
    """Camera-frustum wireframes of world->cam poses [N, 3, 4] (red) over
    ``poses_ref`` (blue) as an image (plot_save_poses_blender,
    util_vis.py:178-250); returns its path. Without matplotlib, writes the
    wireframes' vertices [N, 5, 3] (and the reference's) to ``<path>.npy``,
    says so and returns None."""
    sets = [np.stack([_frustum_points(p, cam_depth) for p in np.asarray(poses)])]
    if poses_ref is not None:
        sets.append(np.stack([_frustum_points(p, cam_depth) for p in np.asarray(poses_ref)]))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.save(os.path.splitext(path)[0] + ".npy", np.stack(sets))
        log.warning(f"no matplotlib: camera wireframes as .npy at "
                    f"{os.path.splitext(path)[0]}.npy")
        return None
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    for pts_set, color in zip(sets[::-1], ["tab:blue", "tab:red"][-len(sets):]):
        for pts in pts_set:
            c, quad = pts[0], pts[1:]
            for q in quad:
                ax.plot(*zip(c, q), color=color, linewidth=0.5)
            loop = np.concatenate([quad, quad[:1]], 0)
            ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], color=color, linewidth=0.5)
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def _imread(path: str) -> Optional[np.ndarray]:
    """An image file as uint8 RGB [H, W, 3] (PIL), or None without PIL."""
    try:
        from PIL import Image
    except ImportError:
        log.warning(f"no PIL: {path} not read")
        return None
    return np.asarray(Image.open(path).convert("RGB"))


def save_pose_evolution_video(pose_history: Sequence[np.ndarray], poses_ref: np.ndarray,
                              out_dir: str, fps: int = 10) -> Optional[str]:
    """One pose plot per entry of ``pose_history`` in ``out_dir``, then a
    video of them (generate_videos_pose, barf.py:264-297); returns the
    video's path, or None where a plot, a reader or an encoder is missing
    (each fallback says so)."""
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i, poses in enumerate(pose_history):
        p = plot_poses(np.asarray(poses), poses_ref, os.path.join(out_dir, f"{i:04d}.png"))
        frame = None if p is None else _imread(p)
        if frame is None:
            return None
        frames.append(frame)
    return write_video(os.path.join(out_dir, "poses.mp4"), frames, fps=fps)


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
