"""Refined-pose export and test-pose transfer (counterpart of
myc_nerfs_tpu/evaluation/pose_export.py; barf garf.py:160-207,
compare_pose.py:9-85).

- ``write_transforms_json``: world->cam poses back to Blender c2w 4x4
  frames in a transforms JSON;
- ``compare_pose``: the per-frame deltas between the original and the
  refined val poses, carried to the test poses by their mean rigid
  transform ('trans', the default) or by a Procrustes sim3 over the camera
  centres ('sim3').

Same JSON schema and formatting as the JAX package (``sort_keys``, indent 4,
separators ", " / ": "). Transforms are f32, as there.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np
import torch

from ..geom import pose as pose_lib
from ..geom.conventions import unparse_camera_barf
from ..geom.procrustes import procrustes_analysis
from .pose_eval import camera_centers

__all__ = ["poses_to_frames", "write_transforms_json", "compare_pose",
           "load_transforms_json"]


def _to_4x4(m34: np.ndarray) -> List[List[float]]:
    return np.concatenate([m34, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0).tolist()


def _dump(payload: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, sort_keys=True, indent=4, separators=(",", ": "))


def poses_to_frames(poses: torch.Tensor, file_pattern: str = "./train/r_{}") -> List[dict]:
    """World->cam poses [N, 3, 4] -> Blender frame dicts with c2w 4x4
    (garf.py:186-201)."""
    c2w = unparse_camera_barf(poses.detach().cpu().float()).numpy()
    return [{"file_path": file_pattern.format(i), "transform_matrix": _to_4x4(c2w[i])}
            for i in range(c2w.shape[0])]


def write_transforms_json(path: str, poses: torch.Tensor,
                          camera_angle_x: float = 1.0471975511965976,
                          file_pattern: str = "./train/r_{}") -> None:
    """A transforms_*.json of the poses (garf.py:202-207)."""
    _dump({"camera_angle_x": camera_angle_x,
           "frames": poses_to_frames(poses, file_pattern)}, path)


def load_transforms_json(path: str):
    """A transforms JSON -> (c2w frames [N, 4, 4] f32 tensor, camera_angle_x,
    the raw dict)."""
    with open(path) as f:
        data = json.load(f)
    mats = np.stack([np.asarray(fr["transform_matrix"], np.float32)[:4]
                     for fr in data["frames"]])
    if mats.shape[1] == 3:
        bottom = np.broadcast_to(np.array([[[0, 0, 0, 1.0]]], np.float32),
                                 (mats.shape[0], 1, 4))
        mats = np.concatenate([mats, bottom], axis=1)
    return torch.from_numpy(mats), data.get("camera_angle_x"), data


def compare_pose(val_old_path: str, val_new_path: str, test_old_path: str,
                 test_new_path: str, method: str = "trans") -> None:
    """Carry the val poses' refinement to the (unseen) test poses and write
    ``test_new_path``: 'trans' applies the mean of the inverted per-frame
    world deltas new_c2w @ inv(old_c2w) to each test c2w; 'sim3' maps each
    test camera by the Procrustes sim3 of the val camera centres, from the
    original frame into the refined one (compare_pose.py:9-85)."""
    if method not in ("trans", "sim3"):
        raise ValueError(f"method {method!r} is not trans or sim3")
    old_c2w, _, _ = load_transforms_json(val_old_path)
    new_c2w, _, _ = load_transforms_json(val_new_path)
    _, _, test_raw = load_transforms_json(test_old_path)

    new_frames = []
    if method == "sim3":
        center_GT = camera_centers(pose_lib.invert_pose(old_c2w[:, :3, :]))
        center_pred = camera_centers(pose_lib.invert_pose(new_c2w[:, :3, :]))
        sim3 = procrustes_analysis(center_GT, center_pred)
        for fr in test_raw["frames"]:
            a34 = torch.tensor(fr["transform_matrix"], dtype=torch.float32)[:3, :]
            a = pose_lib.invert_pose(a34)[None]
            center = camera_centers(a)
            center_aligned = (center - sim3.t0) / sim3.s0 @ sim3.R * sim3.s1 + sim3.t1
            R_aligned = a[..., :3] @ sim3.R
            t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
            c2w = pose_lib.invert_pose(pose_lib.make_pose(R=R_aligned, t=t_aligned))[0]
            new_frames.append({**fr, "transform_matrix": _to_4x4(c2w.numpy())})
    else:
        # the per-frame world transforms, stored inverted as the reference does
        deltas = torch.einsum("nij,njk->nik", new_c2w, torch.linalg.inv(old_c2w))
        trans_mean = pose_lib.invert_pose(deltas[:, :3, :]).numpy().mean(axis=0)
        trans44 = np.concatenate([trans_mean, np.array([[0, 0, 0, 1.0]])], axis=0)
        for fr in test_raw["frames"]:
            a = np.asarray(fr["transform_matrix"], np.float32)
            if a.shape[0] == 3:
                a = np.concatenate([a, np.array([[0, 0, 0, 1.0]], np.float32)], 0)
            new_frames.append({**fr, "transform_matrix": (trans44 @ a).tolist()})
    _dump({**test_raw, "frames": new_frames}, test_new_path)
