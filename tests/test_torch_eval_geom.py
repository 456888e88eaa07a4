"""Port parity of the small geometry and colour modules of the evaluation
slice: utils/color, ops/sh.eval_sh, geom/quaternion, geom/warp2d, and
geom/rays.convert_ndc / points_from_depth and geom/conventions.
parse_raw_camera_barf / matrix_ngp2nerf, each of myc_nerfs_tpu_torch
against myc_nerfs_tpu on the same numpy inputs, with the JAX test suite's
own cases (tests/test_geom.py, test_aux.py, test_render_ops.py,
test_utils_extra.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.geom import conventions as jconv
from myc_nerfs_tpu.geom import quaternion as jq
from myc_nerfs_tpu.geom import rays as jrays
from myc_nerfs_tpu.geom import warp2d as jw
from myc_nerfs_tpu.ops import sh as jsh
from myc_nerfs_tpu.utils import color as jcolor
from myc_nerfs_tpu_torch.geom import conventions as tconv
from myc_nerfs_tpu_torch.geom import quaternion as tq
from myc_nerfs_tpu_torch.geom import rays as trays
from myc_nerfs_tpu_torch.geom import warp2d as tw
from myc_nerfs_tpu_torch.ops import sh as tsh
from myc_nerfs_tpu_torch.utils import color as tcolor

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(a, b, rtol=1e-5, atol=1e-6):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def rand_rot(rng, n):
    """Random rotations by QR (tests/test_geom.py::rand_rot)."""
    Q, R = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    Q = Q * np.sign(np.diagonal(R, axis1=-2, axis2=-1))[..., None, :]
    Q[..., :, 0] *= np.where(np.linalg.det(Q) < 0, -1.0, 1.0)[..., None]
    return Q.astype(np.float32)


def _rotz(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


# --- utils/color -------------------------------------------------------------

def test_color_matches_jax():
    """Both curves on [0, 1] and beyond it (the clip; rtol 1e-6, atol
    1e-7), with the JAX suite's known values and round trip."""
    x = np.concatenate([np.linspace(-0.1, 1.1, 97), [0.0031308, 0.04045, 0.04, 0.5]]
                       ).astype(np.float32)
    for tf, jf in ((tcolor.srgb_to_linear, jcolor.srgb_to_linear),
                   (tcolor.linear_to_srgb, jcolor.linear_to_srgb)):
        ref = np.asarray(jf(jnp.asarray(x)))
        finite = np.isfinite(ref)
        _close(tf(_t(x)).numpy()[finite], ref[finite], rtol=1e-6, atol=1e-7)
    r = np.linspace(0.0, 1.0, 64).astype(np.float32)
    _close(tcolor.srgb_to_linear(tcolor.linear_to_srgb(_t(r))), r, atol=1e-5)
    assert abs(float(tcolor.linear_to_srgb(_t(0.5))) - 0.7354) < 1e-3


def test_blender_reads_bin_through_color(tmp_path):
    """data/blender's packed fp16 .bin reader converts with
    utils/color.linear_to_srgb (rtol 1e-6)."""
    import struct

    from myc_nerfs_tpu_torch.data import blender as tblender

    rgba = np.random.default_rng(0).uniform(0, 1, (3, 4, 4)).astype(np.float16)
    path = tmp_path / "img.bin"
    path.write_bytes(struct.pack("ii", 3, 4) + rgba.tobytes())
    out = tblender._load_image(str(path))
    ref = np.asarray(jcolor.linear_to_srgb(jnp.asarray(rgba[..., :3].astype(np.float32))))
    _close(out[..., :3], ref, rtol=1e-6)
    _close(out[..., 3], rgba[..., 3].astype(np.float32), rtol=0, atol=0)


# --- ops/sh ------------------------------------------------------------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    """eval_sh's contraction of [10, 3, (deg+1)^2] coefficients at unit
    dirs (the JAX suite's case at every degree; rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(3 + deg)
    coeffs = rng.standard_normal((10, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.standard_normal((10, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    _close(tsh.eval_sh(deg, _t(coeffs), _t(d)), jsh.eval_sh(deg, jnp.asarray(coeffs),
                                                             jnp.asarray(d)))


# --- geom/quaternion ---------------------------------------------------------

QUAT_CASES = {
    "random": lambda: rand_rot(np.random.default_rng(7), 64),
    # each of Shepperd's four branches wins: identity (trace), and the
    # half turns about x, y, z (the reference's NaN case, trace -1)
    "branches": lambda: np.stack([np.eye(3, dtype=np.float32),
                                  np.diag([1.0, -1.0, -1.0]).astype(np.float32),
                                  np.diag([-1.0, 1.0, -1.0]).astype(np.float32),
                                  np.diag([-1.0, -1.0, 1.0]).astype(np.float32),
                                  _rotz(np.pi - 1e-4), _rotz(1e-6)]),
}


@pytest.mark.parametrize("case", sorted(QUAT_CASES))
def test_quaternion_matches_jax(case):
    """R_to_q, q_to_R, q_invert and q_product against the JAX functions
    (rtol 1e-5, atol 1e-6); the round trip R -> q -> R and the product as
    composition (atol 1e-4, the JAX suite's)."""
    R = QUAT_CASES[case]()
    q = tq.R_to_q(_t(R))
    qj = jq.R_to_q(jnp.asarray(R))
    _close(q, qj)
    assert (q[..., 0] >= 0).all() and torch.isfinite(q).all()
    _close(tq.q_to_R(q), jq.q_to_R(qj))
    _close(tq.q_to_R(q), R, atol=1e-4)
    _close(tq.q_invert(q), jq.q_invert(qj))
    q2 = torch.roll(q, 1, 0)
    _close(tq.q_product(q, q2), jq.q_product(qj, jnp.roll(qj, 1, 0)))
    _close(tq.q_to_R(tq.q_product(q, q2)), R @ np.roll(R, 1, 0), atol=1e-4)


# --- geom/warp2d -------------------------------------------------------------

def test_so2_se2_maps_match_jax():
    """so2 <-> SO2 and se2 <-> SE2 (theta 0, tiny, moderate) against JAX
    (rtol 1e-5, atol 1e-6), and the JAX suite's round trips."""
    theta = np.asarray([[0.0], [1e-5], [0.3], [-0.7], [2.5]], np.float32)
    R = tw.so2_to_SO2(_t(theta))
    _close(R, jw.so2_to_SO2(jnp.asarray(theta)))
    _close(tw.SO2_to_so2(R), theta, atol=1e-6)
    delta = np.asarray([[0.1, -0.2, 0.0], [0.1, -0.2, 0.4], [0.5, 0.3, -0.9],
                        [0.0, 0.0, 1e-6]], np.float32)
    Rt = tw.se2_to_SE2(_t(delta))
    _close(Rt, jw.se2_to_SE2(jnp.asarray(delta)))
    _close(tw.SE2_to_se2(Rt), jw.SE2_to_se2(jnp.asarray(Rt.numpy())))
    _close(tw.SE2_to_se2(Rt), delta, atol=1e-5)


def test_sl3_matches_jax():
    """sl3_to_SL3 (matrix exponential) against jax.scipy's expm (rtol 1e-5,
    atol 1e-6); identity at 0, unit determinant."""
    h = np.concatenate([np.zeros((1, 8)),
                        [[0.1, -0.05, 0.2, 0.1, 0.05, -0.1, 0.02, 0.03]],
                        np.random.default_rng(4).standard_normal((3, 8)) * 0.3]
                       ).astype(np.float32)
    H = tw.sl3_to_SL3(_t(h))
    _close(H, jw.sl3_to_SL3(jnp.asarray(h)))
    _close(H[0], np.eye(3), atol=1e-6)
    _close(torch.linalg.det(H), np.ones(5), rtol=1e-5)


@pytest.mark.parametrize("warp_type,dim", [("translation", 2), ("rotation", 1), ("rigid", 3),
                                           ("homography", 8)])
def test_warp_grid_matches_jax(warp_type, dim):
    """warp_grid, warp_corners and check_corners_in_range of each warp type
    on the normalised grids (full and crop; rtol 1e-5, atol 1e-6), and the
    corner checks of the JAX suite."""
    rng = np.random.default_rng(dim)
    warp = (rng.standard_normal((2, dim)) * 0.1).astype(np.float32)
    for tg, jg in ((tw.normalized_pixel_grid(4, 6, batch=2),
                    jw.normalized_pixel_grid(4, 6, batch=2)),
                   (tw.normalized_pixel_grid_crop(8, 12, 4, 6, batch=2),
                    jw.normalized_pixel_grid_crop(8, 12, 4, 6, batch=2))):
        _close(tg, jg)
        _close(tw.warp_grid(tg, _t(warp), warp_type),
               jw.warp_grid(jnp.asarray(jg), jnp.asarray(warp), warp_type))
    _close(tw.warp_corners(16, 20, 8, 10, _t(warp), warp_type),
           jw.warp_corners(16, 20, 8, 10, jnp.asarray(warp), warp_type))
    for scale in (0.1, 10.0):
        w = warp * scale
        assert bool(tw.check_corners_in_range(16, 16, 8, 8, _t(w), warp_type)) == \
            bool(jw.check_corners_in_range(16, 16, 8, 8, jnp.asarray(w), warp_type))
    assert bool(tw.check_corners_in_range(16, 16, 8, 8, torch.zeros(1, 2), "translation"))
    assert not bool(tw.check_corners_in_range(16, 16, 8, 8, torch.ones(1, 2) * 10,
                                              "translation"))


# --- geom/rays, geom/conventions ---------------------------------------------

def test_convert_ndc_and_points_match_jax():
    """convert_ndc (the JAX suite's near-plane case and random rays) and
    points_from_depth, one and many samples per ray (rtol 1e-5, atol
    1e-6)."""
    rng = np.random.default_rng(5)
    intr = np.asarray([[[2.0, 0, 1.0], [0, 2.0, 1.0], [0, 0, 1]],
                       [[3.0, 0, 1.5], [0, 2.5, 1.2], [0, 0, 1]]], np.float32)
    center = rng.standard_normal((2, 7, 3)).astype(np.float32) * 0.2
    ray = np.concatenate([rng.standard_normal((2, 7, 2)) * 0.3, np.ones((2, 7, 1))],
                         -1).astype(np.float32)
    c, r = trays.convert_ndc(_t(center), _t(ray), _t(intr), near=1.0)
    cj, rj = jrays.convert_ndc(jnp.asarray(center), jnp.asarray(ray), jnp.asarray(intr), 1.0)
    _close(c, cj)
    _close(r, rj)
    c0, _ = trays.convert_ndc(torch.zeros(2, 7, 3), _t(ray), _t(intr), near=1.0)
    _close(c0[..., 2], -np.ones((2, 7)), atol=1e-6)
    depth = rng.uniform(1, 3, (2, 7, 1)).astype(np.float32)
    _close(trays.points_from_depth(_t(center), _t(ray), _t(depth)),
           jrays.points_from_depth(jnp.asarray(center), jnp.asarray(ray), jnp.asarray(depth)))
    depths = rng.uniform(1, 3, (2, 7, 5, 1)).astype(np.float32)
    _close(trays.points_from_depth(_t(center), _t(ray), _t(depths), multi_samples=True),
           jrays.points_from_depth(jnp.asarray(center), jnp.asarray(ray), jnp.asarray(depths),
                                   multi_samples=True))


def test_barf_parse_and_ngp_inverse_match_jax():
    """parse_raw_camera_barf on [4, 4] and [N, 4, 4] c2w (rtol 1e-5, atol
    1e-6), unparse(parse(c2w)) = c2w (atol 1e-5); matrix_ngp2nerf against
    JAX and as the inverse of matrix_nerf2ngp (atol 1e-5)."""
    rng = np.random.default_rng(9)
    R = rand_rot(rng, 5)
    c2w = np.concatenate([np.concatenate([R, rng.standard_normal((5, 3, 1)) * 2], -1),
                          np.broadcast_to([[[0, 0, 0, 1.0]]], (5, 1, 4))], 1).astype(np.float32)
    p = tconv.parse_raw_camera_barf(_t(c2w))
    _close(p, jconv.parse_raw_camera_barf(jnp.asarray(c2w)))
    _close(tconv.parse_raw_camera_barf(_t(c2w[0])), p[0])
    _close(tconv.unparse_camera_barf(p), c2w[:, :3], atol=1e-5)
    m = rng.standard_normal((3, 4)).astype(np.float32)
    offset = np.asarray([0.5, 0.4, 0.6], np.float32)
    back = tconv.matrix_ngp2nerf(m, 0.33, offset)
    _close(back, jconv.matrix_ngp2nerf(jnp.asarray(m), 0.33, jnp.asarray(offset)))
    _close(tconv.matrix_ngp2nerf(tconv.matrix_nerf2ngp(m, 0.33, offset), 0.33, offset), m,
           atol=1e-5)


def test_barf_views_use_the_parse():
    """data/blender.barf_views' poses are parse_raw_camera_barf of the
    scene's c2w, and match the JAX loader's (rtol 1e-5, atol 1e-6)."""
    from myc_nerfs_tpu.data import blender as jblender
    from myc_nerfs_tpu_torch.data import blender as tblender

    rng = np.random.default_rng(11)
    R = rand_rot(rng, 3)
    c2w = np.concatenate([np.concatenate([R, rng.standard_normal((3, 3, 1))], -1),
                          np.broadcast_to([[[0, 0, 0, 1.0]]], (3, 1, 4))], 1).astype(np.float32)
    kw = dict(images=np.zeros((3, 2, 2, 3), np.float32), alphas=None, c2w=c2w, H=2, W=2,
              focal=1.5, camera_angle_x=1.0, file_paths=["a", "b", "c"])
    _, poses, intr = tblender.barf_views(tblender.BlenderScene(**kw))
    _, jposes, jintr = jblender.barf_views(jblender.BlenderScene(**kw))
    _close(poses, jposes)
    _close(intr, jintr)
    _close(poses, tconv.parse_raw_camera_barf(_t(c2w)), rtol=0, atol=0)
