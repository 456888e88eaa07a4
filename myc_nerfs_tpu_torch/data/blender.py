"""Blender transforms.json datasets (counterpart of
myc_nerfs_tpu/data/blender.py): NGP training's (the jnerf NerfDataset,
dataset.py), BARF's views (``barf_views``) and TensoRF's flat ray store
(``tensorf_ray_store``).

Host-side numpy, as in the JAX package: train = the train and val JSONs
merged, NGP-space poses (correct_pose flips, t * 0.33 + offset, rows
cycled), per-image focal and lens metadata, and an infinite shuffled
stream of (image, pixel) batches whose rays are made on the fly. PIL is
imported only when an image is read.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geom import conventions
from ..geom import rays as rays_lib
from ..utils.color import linear_to_srgb

NERF_SCALE = conventions.NERF_SCALE


@dataclasses.dataclass
class BlenderScene:
    images: np.ndarray          # [N, H, W, 3] float32 in [0, 1]
    alphas: Optional[np.ndarray]  # [N, H, W, 1] or None
    c2w: np.ndarray             # [N, 4, 4] raw Blender camera-to-world
    H: int
    W: int
    focal: float
    camera_angle_x: float
    file_paths: List[str]
    # json-level intrinsics: distortion, principal point, focal lengths
    intrinsics: Optional[Dict] = None


def _load_image(path: str, wh: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """An image as float32 in [0, 1]: PNG/JPEG through PIL, or the
    reference's packed fp16 RGBA ``.bin`` (int32 h, w header, linear
    colour; read_image, dataset.py:54-61) converted to sRGB."""
    if path.endswith(".bin"):
        import struct

        with open(path, "rb") as f:
            raw = f.read()
        h, w = struct.unpack("ii", raw[:8])
        arr = np.frombuffer(raw, np.float16, count=h * w * 4, offset=8)
        arr = arr.astype(np.float32).reshape(h, w, 4).copy()
        arr[..., :3] = linear_to_srgb(torch.from_numpy(arr[..., :3])).numpy()
        return arr
    from PIL import Image

    img = Image.open(path)
    if wh is not None and img.size != wh:
        img = img.resize(wh, Image.LANCZOS)
    return np.asarray(img, np.float32) / 255.0


def load_blender_split(root_dir: str, split: str, downsample: float = 1.0,
                       json_name: Optional[str] = None,
                       require_images: bool = True) -> BlenderScene:
    """Read transforms_{split}.json and its images."""
    name = json_name or f"transforms_{split}.json"
    with open(os.path.join(root_dir, name)) as f:
        meta = json.load(f)
    if not any(k in meta for k in ("camera_angle_x", "fl_x", "camera_angle_y", "fl_y")):
        raise RuntimeError("Couldn't read fov.")  # dataset.py:204
    cax = float(meta.get("camera_angle_x", 0.0))
    c2ws, paths, img_paths = [], [], []
    for fr in meta["frames"]:
        mat = np.asarray(fr["transform_matrix"], np.float32)
        if mat.shape[0] == 3:
            mat = np.concatenate([mat, [[0, 0, 0, 1.0]]], 0)
        fp = fr["file_path"]
        has_ext = fp.endswith((".png", ".bin", ".jpg", ".jpeg"))
        img_path = os.path.join(root_dir, fp if has_ext else fp + ".png")
        if os.path.exists(img_path):
            img_paths.append(img_path)
        elif require_images:
            raise FileNotFoundError(img_path)
        else:
            img_paths.append(None)
        c2ws.append(mat)
        paths.append(fp)

    def load_one(p):
        if p is None:
            return None
        arr = _load_image(p)
        if downsample != 1.0:
            wh = (int(arr.shape[1] / downsample), int(arr.shape[0] / downsample))
            arr = _load_image(p, wh)
        return arr

    if sum(p is not None for p in img_paths) > 4:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as ex:
            loaded = list(ex.map(load_one, img_paths))
    else:
        loaded = [load_one(p) for p in img_paths]
    images, alphas = [], []
    H = W = None
    for arr in loaded:
        if arr is None:
            continue
        if H is None:
            H, W = arr.shape[:2]
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, -1)
        alphas.append(arr[..., 3:4] if arr.shape[-1] == 4 else np.ones_like(arr[..., :1]))
        images.append(arr[..., :3])
    if H is None:
        # splits without images carry their size in the JSON (or default)
        H, W = int(meta.get("h", 800)), int(meta.get("w", 800))
    fl_x, fl_y = meta.get("fl_x"), meta.get("fl_y")
    if fl_x is None and "camera_angle_x" in meta:
        fl_x = 0.5 * W / np.tan(0.5 * cax)
    if fl_y is None and "camera_angle_y" in meta:
        fl_y = 0.5 * H / np.tan(0.5 * float(meta["camera_angle_y"]))
    focal = fl_x if fl_x is not None else fl_y
    intrinsics = {
        "k1": float(meta.get("k1", 0.0)), "k2": float(meta.get("k2", 0.0)),
        "p1": float(meta.get("p1", 0.0)), "p2": float(meta.get("p2", 0.0)),
        "cx": float(meta.get("cx", W / 2.0)),
        "cy": float(meta.get("cy", H / 2.0)),
        "fl_x": float(fl_x if fl_x is not None else focal),
        "fl_y": float(fl_y if fl_y is not None else focal),
    }
    return BlenderScene(
        images=np.stack(images) if images else np.zeros((0, H, W, 3), np.float32),
        alphas=np.stack(alphas) if alphas else None,
        c2w=np.stack(c2ws), H=H, W=W, focal=float(focal), camera_angle_x=cax,
        file_paths=paths, intrinsics=intrinsics)


def blend_background(scene: BlenderScene, bg: float = 1.0) -> np.ndarray:
    """RGBA -> RGB over a constant background."""
    if scene.alphas is None:
        return scene.images
    return scene.images * scene.alphas + bg * (1.0 - scene.alphas)


def barf_views(scene: BlenderScene, bg: float = 1.0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(images [N, H, W, 3], poses [N, 3, 4], intr [N, 3, 3]) in BARF's
    convention, float32: images over the background ``bg``, world->cam
    poses invert(flip(diag(-1, -1, 1)) o c2w) (barf data/blender.py:80-92)."""
    images = blend_background(scene, bg).astype(np.float32)
    c2w = np.asarray(scene.c2w, np.float32)
    poses = conventions.parse_raw_camera_barf(torch.from_numpy(c2w)).numpy()
    intr = np.asarray([[scene.focal, 0, scene.W / 2.0], [0, scene.focal, scene.H / 2.0],
                       [0, 0, 1.0]], np.float32)
    return images, poses, np.broadcast_to(intr, (c2w.shape[0], 3, 3)).copy()


def tensorf_ray_store(scene: BlenderScene, bg: float = 1.0, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(all_rays [N*H*W, 6], all_rgbs [N*H*W, 3]) float32 on ``device``:
    every pixel's (origin, unit direction) under blender2opencv poses
    (tensorf dataLoader/blender.py:63-129), all images at once."""
    images = torch.as_tensor(blend_background(scene, bg).astype(np.float32), device=device)
    c2w = conventions.blender2opencv(torch.as_tensor(np.asarray(scene.c2w, np.float32),
                                                     device=device))[:, :3]
    dirs = rays_lib.get_ray_directions(scene.H, scene.W, scene.focal, device=device)
    rays_d = dirs[None] @ c2w[:, None, :3, :3].transpose(-1, -2)   # [N, H, W, 3]
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    return (torch.cat([rays_o, rays_d], dim=-1).reshape(-1, 6), images.reshape(-1, 3))


@dataclasses.dataclass
class NGPDataset:
    """NGP-space poses + on-the-fly rays for (image, pixel) batches."""

    images: np.ndarray      # [N, H, W, 3]
    alphas: Optional[np.ndarray]
    c2w_ngp: np.ndarray     # [N, 3, 4] NGP-space camera-to-world
    focal: np.ndarray       # [N, 2]
    H: int
    W: int
    aabb_scale: int = 1
    # per-image record [k1, k2, p1, p2, cx/W, cy/H, fx, fy, light_dir(3)]
    metadata: Optional[np.ndarray] = None
    resolutions: Optional[np.ndarray] = None  # [N, 2] (W, H) per image

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def n_pixels(self) -> int:
        return self.H * self.W

    @classmethod
    def from_scene(cls, scene: BlenderScene, aabb_scale: int = 1,
                   scale: Optional[float] = None, offset=None,
                   correct_pose=(-1, -1, 1)) -> "NGPDataset":
        scale = NERF_SCALE if scale is None else scale
        offset = np.asarray([0.5, 0.5, 0.5] if offset is None else offset, np.float32)
        mats = np.stack([conventions.matrix_nerf2ngp(m[:3], scale, offset,
                                                     correct_pose=correct_pose)
                         for m in scene.c2w])
        n = mats.shape[0]
        intr = scene.intrinsics or {}
        fx = intr.get("fl_x", scene.focal)
        fy = intr.get("fl_y", scene.focal)
        focal = np.broadcast_to(np.asarray([fx, fy], np.float32), (n, 2))
        md = np.zeros(11, np.float32)
        md[0], md[1] = intr.get("k1", 0.0), intr.get("k2", 0.0)
        md[2], md[3] = intr.get("p1", 0.0), intr.get("p2", 0.0)
        md[4] = intr.get("cx", scene.W / 2.0) / scene.W
        md[5] = intr.get("cy", scene.H / 2.0) / scene.H
        md[6], md[7] = fx, fy
        resolutions = np.repeat(np.asarray([[scene.W, scene.H]], np.float32), n, axis=0)
        return cls(images=scene.images, alphas=scene.alphas, c2w_ngp=mats,
                   focal=np.array(focal), H=scene.H, W=scene.W,
                   aabb_scale=aabb_scale, metadata=np.repeat(md[None], n, axis=0),
                   resolutions=resolutions)

    def rays_for_pixels(self, img_ids: np.ndarray, pix_ids: np.ndarray):
        """(origins, unit directions) [n, 3] for (image, pixel) pairs
        (generate_random_data, dataset.py:230-246): principal point and
        per-image focal from the metadata, OpenCV undistortion when
        k1/k2/p1/p2 are nonzero."""
        x = (pix_ids % self.W + 0.5).astype(np.float32)
        y = (pix_ids // self.W + 0.5).astype(np.float32)
        if self.metadata is not None:
            md = self.metadata[img_ids]
            fx, fy = md[:, 6], md[:, 7]
            cx, cy = md[:, 4] * self.W, md[:, 5] * self.H
            u = (x - cx) / fx
            v = (y - cy) / fy
            if np.abs(md[:, 0:4]).max() > 0:
                u, v = _undistort_opencv(u, v, md[:, 0], md[:, 1], md[:, 2], md[:, 3])
            dirs = np.stack([u, v, np.ones_like(u)], -1)
        else:
            f = self.focal[img_ids]
            dirs = np.stack([(x - self.W / 2.0) / f[:, 0],
                             (y - self.H / 2.0) / f[:, 1], np.ones_like(x)], -1)
        m = self.c2w_ngp[img_ids]
        d = np.einsum("nij,nj->ni", m[:, :, :3], dirs)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return m[:, :, 3].astype(np.float32), d.astype(np.float32)

    def pixel_values(self, img_ids, pix_ids, bg: Optional[np.ndarray] = None):
        """Target RGB, RGBA composited over the per-ray ``bg`` (runner.py:66-68)."""
        rgb = self.images.reshape(self.images.shape[0], -1, 3)[img_ids, pix_ids]
        if self.alphas is not None and bg is not None:
            a = self.alphas.reshape(self.alphas.shape[0], -1, 1)[img_ids, pix_ids]
            rgb = rgb * a + bg * (1.0 - a)
        return rgb.astype(np.float32)


def _undistort_opencv(u, v, k1, k2, p1, p2, iters: int = 3):
    """Iterative OpenCV lens undistortion of normalized image coordinates."""
    u0, v0 = u, v
    for _ in range(iters):
        r2 = u * u + v * v
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        du = 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
        dv = p1 * (r2 + 2 * v * v) + 2 * p2 * u * v
        u = (u0 - du) / rad
        v = (v0 - dv) / rad
    return u, v


class RayBatcher:
    """Infinite shuffled (image, pixel) batches (dataset.py:116-125), on
    numpy's default_rng: the same seed gives the JAX package's batches."""

    def __init__(self, n_images: int, n_pixels: int, batch: int, seed: int = 0):
        self.total = n_images * n_pixels
        self.n_pixels = n_pixels
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self._perm = self.rng.permutation(self.total)
        self._ptr = 0

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._ptr + self.batch > self.total:
            self._perm = self.rng.permutation(self.total)
            self._ptr = 0
        ids = self._perm[self._ptr:self._ptr + self.batch]
        self._ptr += self.batch
        return ((ids // self.n_pixels).astype(np.int32),
                (ids % self.n_pixels).astype(np.int32))


def load_ngp_train_data(root_dir: str, aabb_scale: int = 1,
                        scale: Optional[float] = None, offset=None,
                        correct_pose=(-1, -1, 1)) -> NGPDataset:
    """jnerf train mode merges the train and val JSONs (dataset.py:127-147)."""
    scenes = [load_blender_split(root_dir, split) for split in ("train", "val")
              if os.path.exists(os.path.join(root_dir, f"transforms_{split}.json"))]
    if not scenes:
        raise FileNotFoundError(f"no transforms_*.json under {root_dir}")
    base = scenes[0]
    if len(scenes) > 1 and scenes[1].images.shape[0]:
        base = BlenderScene(
            images=np.concatenate([s.images for s in scenes]),
            alphas=(np.concatenate([s.alphas for s in scenes])
                    if all(s.alphas is not None for s in scenes) else None),
            c2w=np.concatenate([s.c2w for s in scenes]),
            H=base.H, W=base.W, focal=base.focal,
            camera_angle_x=base.camera_angle_x,
            file_paths=base.file_paths + scenes[1].file_paths)
    return NGPDataset.from_scene(base, aabb_scale=aabb_scale, scale=scale,
                                 offset=offset, correct_pose=correct_pose)
