"""Port parity of the BARF camera algebra: the SO(3)/SE(3) exp and log maps
and their gradients (at theta = 0 and at random theta), the pose helpers,
Procrustes alignment and the pose errors, the BARF pose conventions, and
the positional encoding with BARF's coarse-to-fine mask, each of
myc_nerfs_tpu_torch against myc_nerfs_tpu on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.data import blender as jblender
from myc_nerfs_tpu.evaluation import pose_eval as jeval
from myc_nerfs_tpu.geom import conventions as jconv
from myc_nerfs_tpu.geom import lie as jlie
from myc_nerfs_tpu.geom import pose as jpose
from myc_nerfs_tpu.geom import procrustes as jproc
from myc_nerfs_tpu.ops import encoding as jenc
from myc_nerfs_tpu_torch.data import blender as tblender
from myc_nerfs_tpu_torch.evaluation import pose_eval as teval
from myc_nerfs_tpu_torch.geom import conventions as tconv
from myc_nerfs_tpu_torch.geom import lie as tlie
from myc_nerfs_tpu_torch.geom import pose as tpose
from myc_nerfs_tpu_torch.geom import procrustes as tproc
from myc_nerfs_tpu_torch.ops import encoding as tenc

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), rtol=rtol, atol=atol)


def _se3(seed, n=5, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((n, 6)) * scale).astype(np.float32)


def _poses(seed, n=6):
    return np.asarray(jlie.se3_to_SE3(jnp.asarray(_se3(seed, n, 0.8))))


# theta = 0 (exactly), tiny, moderate and near pi
LIE_CASES = {"zero": np.zeros((3, 6), np.float32), "tiny": _se3(0, 3, 1e-4),
             "random": _se3(1, 5, 0.5), "large": _se3(2, 4, 1.2)}


@pytest.mark.parametrize("case", sorted(LIE_CASES))
def test_lie_maps_match_jax(case):
    """skew, so3_to_SO3, se3_to_SE3, the log maps SO3_to_so3 / SE3_to_se3
    on their outputs and the three series (rtol 1e-5, atol 1e-6: the same
    series in f32, one library's rounding from the other's)."""
    wu = LIE_CASES[case]
    _close(tlie.skew(_t(wu[:, :3])), jlie.skew(jnp.asarray(wu[:, :3])))
    R_t, R_j = tlie.so3_to_SO3(_t(wu[:, :3])), jlie.so3_to_SO3(jnp.asarray(wu[:, :3]))
    _close(R_t, R_j)
    Rt_t, Rt_j = tlie.se3_to_SE3(_t(wu)), jlie.se3_to_SE3(jnp.asarray(wu))
    _close(Rt_t, Rt_j)
    _close(tlie.SO3_to_so3(_t(R_j)), jlie.SO3_to_so3(R_j), atol=2e-5)
    _close(tlie.SE3_to_se3(_t(Rt_j)), jlie.SE3_to_se3(Rt_j), atol=2e-5)
    x = np.linspace(0.0, 2.0, 7, dtype=np.float32)
    _close(tlie.taylor_A(_t(x)), jlie.taylor_A(jnp.asarray(x)))
    for tf, jf in ((tlie._B_sq, jlie.taylor_B), (tlie._C_sq, jlie.taylor_C)):
        _close(tf(_t(x * x)), jf(jnp.asarray(x)))


@pytest.mark.parametrize("case", sorted(LIE_CASES))
def test_se3_to_SE3_gradient_matches_jax(case):
    """The gradient of a loss through se3_to_SE3 composed with a pose, as the
    trainer's pose correction takes it: finite at theta = 0 (a norm or
    sin(theta)/theta form gives NaN there) and equal to JAX's (rtol 1e-5,
    atol 1e-6)."""
    wu = LIE_CASES[case]
    poses = _poses(3, wu.shape[0])
    w = np.random.default_rng(4).standard_normal(poses.shape).astype(np.float32)

    def jloss(x):
        return (jpose.compose_pair(jlie.se3_to_SE3(x), jnp.asarray(poses)) * w).sum()

    g_ref = jax.grad(jloss)(jnp.asarray(wu))
    x = _t(wu).requires_grad_(True)
    (tpose.compose_pair(tlie.se3_to_SE3(x), _t(poses)) * _t(w)).sum().backward()
    assert torch.isfinite(x.grad).all()
    _close(x.grad, g_ref)
    xs = _t(wu[:, :3]).requires_grad_(True)
    (tlie.so3_to_SO3(xs) * _t(w[:, :, :3])).sum().backward()
    _close(xs.grad, jax.grad(lambda v: (jlie.so3_to_SO3(v) * w[:, :, :3]).sum())(
        jnp.asarray(wu[:, :3])))


def test_pose_helpers_match_jax():
    """make_pose (R only, t only, both), invert_pose, compose_pair, compose,
    world2cam, cam2world, cam2img, img2cam, rotation_distance,
    angle_to_rotation_matrix on each axis and get_novel_view_poses (rtol
    1e-5, atol 1e-5)."""
    rng = np.random.default_rng(5)
    pa, pb, pc = _poses(6), _poses(7), _poses(8)
    R, t = pa[..., :3], pa[..., 3]
    _close(tpose.make_pose(R=_t(R)), jpose.make_pose(R=jnp.asarray(R)))
    _close(tpose.make_pose(t=_t(t)), jpose.make_pose(t=jnp.asarray(t)))
    _close(tpose.make_pose(R=_t(R), t=_t(t)), jpose.make_pose(R=jnp.asarray(R), t=jnp.asarray(t)))
    _close(tpose.invert_pose(_t(pa)), jpose.invert_pose(jnp.asarray(pa)), atol=1e-5)
    _close(tpose.compose_pair(_t(pa), _t(pb)), jpose.compose_pair(jnp.asarray(pa),
                                                                 jnp.asarray(pb)), atol=1e-5)
    _close(tpose.compose([_t(pa), _t(pb), _t(pc)]),
           jpose.compose([jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(pc)]), atol=1e-5)
    X = rng.standard_normal((6, 10, 3)).astype(np.float32)
    _close(tpose.world2cam(_t(X), _t(pa)), jpose.world2cam(jnp.asarray(X), jnp.asarray(pa)),
           atol=1e-5)
    _close(tpose.cam2world(_t(X), _t(pa)), jpose.cam2world(jnp.asarray(X), jnp.asarray(pa)),
           atol=1e-5)
    K = np.array([[30.0, 0, 10], [0, 30.0, 12], [0, 0, 1]], np.float32)
    _close(tpose.cam2img(_t(X), _t(K)), jpose.cam2img(jnp.asarray(X), jnp.asarray(K)), atol=1e-4)
    _close(tpose.img2cam(_t(X), _t(K)), jpose.img2cam(jnp.asarray(X), jnp.asarray(K)))
    _close(tpose.rotation_distance(_t(pa[..., :3]), _t(pb[..., :3])),
           jpose.rotation_distance(jnp.asarray(pa[..., :3]), jnp.asarray(pb[..., :3])),
           atol=1e-4)
    a = rng.uniform(-3, 3, (7,)).astype(np.float32)
    for axis in "XYZ":
        _close(tpose.angle_to_rotation_matrix(_t(a), axis),
               jpose.angle_to_rotation_matrix(jnp.asarray(a), axis))
    _close(tpose.get_novel_view_poses(_t(pa[0]), N=12, scale=1.5),
           jpose.get_novel_view_poses(jnp.asarray(pa[0]), N=12, scale=1.5), atol=1e-5)


def test_procrustes_and_pose_errors_match_jax():
    """procrustes_analysis (a reflected point set included: the branch-free
    fix flips R's last row), apply_sim3, align_poses_sim3, prealign_cameras
    and evaluate_camera_alignment on noisy poses (atol 1e-5, rotation errors
    2e-4: arccos near 1 magnifies f32 rounding)."""
    rng = np.random.default_rng(9)
    X0 = rng.standard_normal((10, 3)).astype(np.float32)
    for X1 in (X0 * 1.7 @ np.asarray(_poses(10, 1)[0, :, :3]).T + 0.3,
               X0 * np.array([1, 1, -1], np.float32) + 0.05 * rng.standard_normal((10, 3))):
        X1 = X1.astype(np.float32)
        s_t = tproc.procrustes_analysis(_t(X0), _t(X1))
        s_j = jproc.procrustes_analysis(jnp.asarray(X0), jnp.asarray(X1))
        for a, b in zip(s_t, s_j):
            _close(a, b, atol=1e-5)
        assert np.linalg.det(s_t.R.numpy()) > 0
        _close(tproc.apply_sim3(s_t, _t(X1)), jproc.apply_sim3(s_j, jnp.asarray(X1)), atol=1e-5)
        P = _poses(11, 10)
        _close(tproc.align_poses_sim3(s_t, _t(P)), jproc.align_poses_sim3(s_j, jnp.asarray(P)),
               atol=1e-5)
    gt = _poses(12, 8)
    noisy = np.asarray(jpose.compose_pair(jlie.se3_to_SE3(jnp.asarray(_se3(13, 8, 0.05))),
                                          jnp.asarray(gt)))
    al_t, _ = teval.prealign_cameras(_t(noisy), _t(gt))
    al_j, _ = jeval.prealign_cameras(jnp.asarray(noisy), jnp.asarray(gt))
    _close(al_t, al_j, atol=1e-5)
    e_t = teval.evaluate_camera_alignment(al_t, _t(gt))
    e_j = jeval.evaluate_camera_alignment(al_j, jnp.asarray(gt))
    _close(e_t.R, e_j.R, atol=2e-4)
    _close(e_t.t, e_j.t, atol=1e-5)


def test_barf_conventions_match_jax():
    """barf_views (numpy) against the JAX package's on a BlenderScene with
    alphas, and unparse_camera_barf back to the scene's c2w (atol 1e-5)."""
    rng = np.random.default_rng(14)
    c2w = np.concatenate([np.asarray(jpose.invert_pose(jnp.asarray(_poses(15, 3)))),
                          np.broadcast_to([[[0, 0, 0, 1.0]]], (3, 1, 4))], 1).astype(np.float32)
    kw = dict(images=rng.uniform(0, 1, (3, 4, 5, 3)).astype(np.float32),
              alphas=rng.uniform(0, 1, (3, 4, 5, 1)).astype(np.float32), c2w=c2w, H=4, W=5,
              focal=6.5, camera_angle_x=0.7, file_paths=["a", "b", "c"])
    out_t = tblender.barf_views(tblender.BlenderScene(**kw), bg=0.3)
    out_j = jblender.barf_views(jblender.BlenderScene(**kw), bg=0.3)
    for a, b in zip(out_t, out_j):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        _close(a, b, atol=1e-5)
    _close(tconv.unparse_camera_barf(torch.from_numpy(out_t[1])),
           jconv.unparse_camera_barf(out_j[1]), atol=1e-5)
    _close(tconv.unparse_camera_barf(torch.from_numpy(out_t[1])), c2w[:, :3], atol=1e-5)


@pytest.mark.parametrize("progress", [0.0, 0.2, 0.3, 0.45, 1.0])
def test_positional_encoding_and_c2f_match_jax(progress):
    """positional_encoding's [..., N, 2, L] layout, barf_c2f_weights at
    progress values before, inside and after the [0.1, 0.5] ramp, and
    apply_c2f_mask (rtol 1e-5, atol 1e-5: sin of up to 2^9 pi x)."""
    x = np.random.default_rng(16).uniform(-1.5, 1.5, (2, 7, 3)).astype(np.float32)
    enc_t, enc_j = tenc.positional_encoding(_t(x), 10), jenc.positional_encoding(jnp.asarray(x), 10)
    assert enc_t.shape == (2, 7, 60)
    _close(enc_t, enc_j, atol=1e-5)
    w_t = tenc.barf_c2f_weights(torch.tensor(progress, dtype=torch.float32), 10, (0.1, 0.5))
    w_j = jenc.barf_c2f_weights(jnp.float32(progress), 10, (0.1, 0.5))
    _close(w_t, w_j)
    _close(tenc.apply_c2f_mask(enc_t, w_t, 3), jenc.apply_c2f_mask(enc_j, w_j, 3), atol=1e-5)
