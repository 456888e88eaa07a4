"""Port parity of the NGP training data: the blender loader, NGPDataset
(poses, rays with and without lens distortion, composited pixels),
RayBatcher and load_ngp_train_data of myc_nerfs_tpu_torch.data against
myc_nerfs_tpu.data, on a tiny blender scene the test writes itself."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from myc_nerfs_tpu.data import blender as jbl
from myc_nerfs_tpu.geom import conventions as jconv
from myc_nerfs_tpu_torch.data import blender as tbl
from myc_nerfs_tpu_torch.geom import conventions as tconv

torch.set_num_threads(1)

H, W = 6, 8  # not square, so H/W mix-ups show


def _pose(rng):
    """A random camera-to-world 4x4: rotation from a QR, translation ~3."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m.tolist()


@pytest.fixture(scope="module", params=["pinhole", "distorted"])
def scene_dir(request, tmp_path_factory):
    """transforms_{train,val}.json with RGBA PNGs: camera_angle_x only, or
    explicit fl_x/fl_y, principal point and k1/k2/p1/p2."""
    root = tmp_path_factory.mktemp(request.param)
    rng = np.random.default_rng(0)
    meta = {"camera_angle_x": 0.69}
    if request.param == "distorted":
        meta.update(fl_x=9.5, fl_y=8.75, cx=4.25, cy=2.75,
                    k1=0.05, k2=-0.01, p1=0.002, p2=-0.003)
    for split, n in (("train", 3), ("val", 2)):
        frames = []
        for i in range(n):
            name = f"{split}/r_{i}"
            (root / split).mkdir(exist_ok=True)
            rgba = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
            Image.fromarray(rgba, "RGBA").save(root / f"{name}.png")
            frames.append({"file_path": name, "transform_matrix": _pose(rng)})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({**meta, "frames": frames}))
    return str(root)


def test_matrix_nerf2ngp_matches_jax():
    m = np.asarray(_pose(np.random.default_rng(1)), np.float32)
    for cp in ((-1, -1, 1), (1, -1, -1)):
        ref = jconv.matrix_nerf2ngp(jnp.asarray(m[:3]), 0.33,
                                    jnp.asarray([-2.0, -0.5, 0.0]), correct_pose=cp)
        out = tconv.matrix_nerf2ngp(m[:3], 0.33, [-2.0, -0.5, 0.0], correct_pose=cp)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_load_blender_split_matches_jax(scene_dir):
    """Images and alphas bit-exact (the same PNG decode); poses, focal and
    intrinsics equal."""
    ref = jbl.load_blender_split(scene_dir, "train")
    out = tbl.load_blender_split(scene_dir, "train")
    np.testing.assert_array_equal(out.images, ref.images)
    np.testing.assert_array_equal(out.alphas, ref.alphas)
    np.testing.assert_array_equal(out.c2w, ref.c2w)
    assert (out.H, out.W, out.file_paths) == (ref.H, ref.W, ref.file_paths)
    assert out.focal == ref.focal and out.intrinsics == ref.intrinsics


def test_ngp_dataset_and_train_data_match_jax(scene_dir):
    """load_ngp_train_data (train + val merged): NGP poses, focal and
    metadata to 1e-6; rays for every pixel of every image to 1e-6 (the
    undistortion iterates the same float32 arithmetic); targets composited
    over per-ray backgrounds exactly."""
    kw = dict(aabb_scale=4, offset=[-2.0, -0.5, 0.0], correct_pose=(-1, -1, 1))
    ref = jbl.load_ngp_train_data(scene_dir, **kw)
    out = tbl.load_ngp_train_data(scene_dir, **kw)
    assert out.n_images == ref.images.shape[0] == 5 and out.n_pixels == H * W
    np.testing.assert_array_equal(out.images, ref.images)
    np.testing.assert_allclose(out.c2w_ngp, ref.c2w_ngp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out.focal, ref.focal)
    np.testing.assert_array_equal(out.metadata, ref.metadata)
    np.testing.assert_array_equal(out.resolutions, ref.resolutions)
    img = np.repeat(np.arange(5, dtype=np.int32), H * W)
    pix = np.tile(np.arange(H * W, dtype=np.int32), 5)
    for a, b in zip(out.rays_for_pixels(img, pix), ref.rays_for_pixels(img, pix)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    bg = np.random.default_rng(2).uniform(0, 1, (img.size, 3)).astype(np.float32)
    np.testing.assert_array_equal(out.pixel_values(img, pix, bg=bg),
                                  ref.pixel_values(img, pix, bg=bg))


def test_ray_batcher_matches_jax():
    """Same seeds, same (image, pixel) batches, through two reshuffles."""
    ref = jbl.RayBatcher(3, 48, 40, seed=5)
    out = tbl.RayBatcher(3, 48, 40, seed=5)
    for _ in range(9):
        for a, b in zip(out.next(), ref.next()):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_eval_views_of_blender_data_match_jax(scene_dir):
    """run_net.load_eval_views on blender data (the val split): the same
    backgrounds-blended images, NGP poses and intrinsics as the JAX
    run_net's."""
    from myc_nerfs_tpu.cli import run_net as jrn
    from myc_nerfs_tpu_torch.cli import run_net as trn

    cfg = {"dataset": {"train": {"root_dir": scene_dir, "aabb_scale": 4}}}
    ref = jrn.load_eval_views(cfg, None, H, W)
    out = trn.load_eval_views(cfg)
    np.testing.assert_array_equal(out[0], ref[0])
    for a, b in zip(out[1], ref[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(out[2], ref[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
