"""Port parity of TensoRF's host and sampling ops against the JAX package:
grid_sample_2d/3d and the line lerp (values and the gradient of the grid),
cell_base_index (exact, on cell planes and at +-1 too), SSIM, the ray
helpers and tensorf's ray store, the depth colormap, tiling and the video
fallback, and the marching tetrahedra of the mesh export."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.data import blender as jblender
from myc_nerfs_tpu.evaluation import visualization as jvis
from myc_nerfs_tpu.geom import conventions as jconv, rays as jrays
from myc_nerfs_tpu.models import tensorf as jtf
from myc_nerfs_tpu.ops import grid_sample as jgs
from myc_nerfs_tpu.ops.native import marching_tets_numpy
from myc_nerfs_tpu.utils import metrics as jmetrics
from myc_nerfs_tpu_torch.data import blender as tblender
from myc_nerfs_tpu_torch.evaluation import mesh as tmesh, visualization as tvis
from myc_nerfs_tpu_torch.geom import conventions as tconv, rays as trays
from myc_nerfs_tpu_torch.ops import grid_sample as tgs
from myc_nerfs_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def _coords(rng, n, k):
    """Uniform in [-1.1, 1.1] (past the border on both sides) with +-1,
    0 and the corners planted."""
    c = rng.uniform(-1.1, 1.1, (n, k)).astype(np.float32)
    c[:4] = [[-1.0] * k, [1.0] * k, [0.0] * k, [1.0, -1.0, 1.0][:k]]
    return c


@pytest.mark.parametrize("shape", [(5, 7, 9), (3, 4, 6, 5), (2, 1, 8)])
def test_grid_sample_matches_jax(shape):
    """grid_sample_2d / 3d against the JAX gather + lerp, values and the
    grid's gradient under a random cotangent: rtol 1e-5 / atol 1e-6 (the
    lerp's weights are rounded in another order)."""
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    grid = rng.standard_normal(shape).astype(np.float32)
    k = len(shape) - 1
    coords = _coords(rng, 300, k).reshape(20, 15, k)
    cot = rng.standard_normal((20, 15, shape[0])).astype(np.float32)
    jf = jgs.grid_sample_2d if k == 2 else jgs.grid_sample_3d
    tf_ = tgs.grid_sample_2d if k == 2 else tgs.grid_sample_3d
    ref, vjp = jax.vjp(lambda g: jf(g, jnp.asarray(coords)), jnp.asarray(grid))
    (ref_g,) = vjp(jnp.asarray(cot))
    g = torch.tensor(grid, requires_grad=True)
    out = tf_(g, torch.from_numpy(coords))
    (out_g,) = torch.autograd.grad(out, g, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [2, 9, 33])
def test_line_sample_matches_jax(length):
    """line_sample against the JAX _line_sample, value and gradient (rtol
    1e-5 / atol 1e-6)."""
    rng = np.random.default_rng(length)
    line = rng.standard_normal((6, length)).astype(np.float32)
    t = _coords(rng, 200, 1)[:, 0].reshape(10, 20)
    cot = rng.standard_normal((10, 20, 6)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jtf._line_sample(v, jnp.asarray(t)), jnp.asarray(line))
    (ref_g,) = vjp(jnp.asarray(cot))
    v = torch.tensor(line, requires_grad=True)
    out = tgs.line_sample(v, torch.from_numpy(t))
    (out_g,) = torch.autograd.grad(out, v, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [1, 2, 7, 31, 256])
def test_cell_base_index_exact(size):
    """cell_base_index equals the JAX index element for element: random
    coords, the cell planes k / (size - 1) * 2 - 1 and one f32 step either
    side of each, +-1 and beyond."""
    rng = np.random.default_rng(size)
    planes = (np.arange(size, dtype=np.float32) / max(size - 1, 1) * 2 - 1).astype(np.float32)
    c = np.concatenate([
        rng.uniform(-1.2, 1.2, 4000).astype(np.float32), planes,
        np.nextafter(planes, np.float32(2)), np.nextafter(planes, np.float32(-2)),
        np.asarray([-1, 1, -1.5, 1.5, 0, np.nextafter(np.float32(1), 0),
                    np.nextafter(np.float32(-1), 0)], np.float32)]).astype(np.float32)
    ref = np.asarray(jgs.cell_base_index(jnp.asarray(c), size))
    out = tgs.cell_base_index(torch.from_numpy(c), size).numpy()
    np.testing.assert_array_equal(out, ref)


def test_ssim_matches_jax():
    """ssim against the JAX gaussian-window SSIM (rtol 1e-5), on a pair of
    related images and an image with itself (1)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (24, 30, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ref = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    out = float(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(a))),
                               1.0, rtol=1e-6)


def test_ray_helpers_match_jax():
    """get_rays_from_directions and blender2opencv against JAX (rtol 1e-6 /
    atol 1e-6), and tensorf_ray_store on a three-view scene against the JAX
    loader's rays and colours (atol 1e-6)."""
    rng = np.random.default_rng(4)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i in range(3):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        c2w[i, :3, :3] = q
        c2w[i, :3, 3] = rng.uniform(-4, 4, 3)
    cv = tconv.blender2opencv(torch.from_numpy(c2w)).numpy()
    np.testing.assert_allclose(cv, np.asarray(jconv.blender2opencv(jnp.asarray(c2w))), atol=1e-7)
    dirs = jrays.get_ray_directions(6, 8, 7.5)
    o, d = jrays.get_rays_from_directions(dirs, jnp.asarray(cv[0, :3]))
    to, td = trays.get_rays_from_directions(torch.from_numpy(np.array(dirs)),
                                            torch.from_numpy(cv[0, :3]))
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=1e-6, atol=1e-6)
    images = rng.uniform(0, 1, (3, 6, 8, 3)).astype(np.float32)
    alphas = rng.uniform(0, 1, (3, 6, 8, 1)).astype(np.float32)
    scene = jblender.BlenderScene(images=images, alphas=alphas, c2w=c2w, H=6, W=8, focal=7.5,
                                  camera_angle_x=1.0, file_paths=[])
    rays, rgbs = jblender.tensorf_ray_store(scene, bg=1.0)
    tscene = tblender.BlenderScene(images=images, alphas=alphas, c2w=c2w, H=6, W=8, focal=7.5,
                                   camera_angle_x=1.0, file_paths=[])
    trays_, trgbs = tblender.tensorf_ray_store(tscene, bg=1.0)
    np.testing.assert_allclose(trays_.numpy(), np.asarray(rays), atol=1e-6)
    np.testing.assert_allclose(trgbs.numpy(), np.asarray(rgbs), atol=1e-7)


def test_visualization_matches_jax(tmp_path, monkeypatch):
    """visualize_depth against the JAX one (cv2's JET): within one 8-bit
    level, the same (min, max); tile_images exact; write_video without cv2
    writes PNG frames, and without PIL too .npy frames, and returns None."""
    rng = np.random.default_rng(5)
    depth = rng.uniform(0, 5, (9, 11)).astype(np.float32)
    depth[0, :3] = 0.0
    ref, ref_mm = jvis.visualize_depth(depth)
    out, mm = tvis.visualize_depth(depth)
    assert mm == ref_mm
    np.testing.assert_allclose(out, ref, atol=1.0 / 255 + 1e-7)
    imgs = rng.uniform(0, 1, (5, 4, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.tile_images(imgs, cols=2), jvis.tile_images(imgs, cols=2))
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tvis.write_video(str(tmp_path / "a.mp4"), list(imgs)) is None
    assert sorted(os.listdir(tmp_path / "a")) == [f"{i:04d}.png" for i in range(5)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tvis.write_video(str(tmp_path / "b.mp4"), list(imgs)) is None
    frames = sorted(os.listdir(tmp_path / "b"))
    assert frames == [f"{i:04d}.npy" for i in range(5)]
    np.testing.assert_array_equal(np.load(tmp_path / "b" / frames[2]),
                                  (imgs[2] * 255).astype(np.uint8))


def test_marching_tets_matches_jax_numpy(tmp_path):
    """The port's marching tetrahedra against the JAX package's numpy
    version on a noisy sphere: the same vertices (exact) and triangles, in
    the same order; the PLY writer puts them in the file."""
    t = np.linspace(-1, 1, 14, dtype=np.float32)
    X, Y, Z = np.meshgrid(t, t, t, indexing="ij")
    rng = np.random.default_rng(6)
    grid = (1.0 - np.sqrt(X**2 + Y**2 + Z**2) + 0.05 * rng.standard_normal(X.shape)
            ).astype(np.float32)
    v_ref, t_ref = marching_tets_numpy(grid, 0.3)
    v, tris = tmesh.marching_tets(grid, 0.3)
    assert len(t_ref) > 100
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(tris, t_ref)
    n_v, n_f = tmesh.convert_density_samples_to_ply(grid, str(tmp_path / "m.ply"),
                                                    np.asarray([[-1.0] * 3, [1.0] * 3]), 0.3)
    lines = open(tmp_path / "m.ply").read().splitlines()
    assert (n_v, n_f) == (len(v_ref), len(t_ref))
    assert lines[2] == f"element vertex {n_v}" and len(lines) == 9 + n_v + n_f
