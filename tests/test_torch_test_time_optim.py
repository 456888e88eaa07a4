"""Port parity of evaluation/test_time_optim: test_time_pose_optim's stop
iteration and result against the JAX while loop (the JAX suite's quadratic
and converged-start cases, a plateau and a cap), its independence of how
often the host reads the stop flag, and make_ngp_pose_loss's loss and
d loss / d se3 on a trained NGP field at the JAX suite's shape
(tests/test_pose_pipeline.py:167-220), then a short optimisation through
it with the JAX run's pixel draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.evaluation import test_time_optim as jtt
from myc_nerfs_tpu_torch.evaluation import test_time_optim as ttt

torch.set_num_threads(1)

TARGET = np.asarray([[0.1, -0.2, 0.05, 0.3, 0.0, -0.1]], np.float32)

# name: (loss offset, lr, max_iter, stop_loss, plateau_after, patience)
CASES = {
    "quadratic": (0.0, 1e-2, 5000, 1e-4, 1500, 200),       # test_pose_pipeline.py:106
    "converged_start": (1e-5, 3e-3, 100, 7e-4, 1500, 200),  # :222, target 0
    "plateau": (0.5, 1e-2, 5000, 1e-4, 60, 25),
    "cap": (0.0, 1e-3, 137, 1e-12, 1500, 200),
}


def _loss_pair(case):
    offset = CASES[case][0]
    target = np.zeros((1, 6), np.float32) if case == "converged_start" else TARGET

    def jloss(se3, key):
        return ((se3 - jnp.asarray(target)) ** 2).sum() + offset

    def tloss(se3, draws):
        return ((se3 - torch.from_numpy(target)) ** 2).sum() + offset

    return jloss, tloss


@pytest.mark.parametrize("case", sorted(CASES))
def test_stop_iteration_and_se3_match_jax(case):
    """The same stop iteration as the JAX while loop, exactly; the best se3
    and its loss within rtol 1e-4 / atol 1e-6 (optax's Adam and the port's
    adam_step round alike, in f32); the stop reason the case names."""
    _, lr, max_iter, stop_loss, plateau_after, patience = CASES[case]
    jloss, tloss = _loss_pair(case)
    kw = dict(lr=lr, max_iter=max_iter, stop_loss=stop_loss, plateau_after=plateau_after,
              patience=patience)
    ref = jtt.test_time_pose_optim(jloss, jax.random.PRNGKey(0), **kw)
    out = ttt.test_time_pose_optim(tloss, lambda it: None, device="cpu", **kw)
    assert int(out.n_iters) == int(ref.n_iters), (int(out.n_iters), int(ref.n_iters))
    np.testing.assert_allclose(out.se3.numpy(), np.asarray(ref.se3), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(out.loss), float(ref.loss), rtol=1e-4, atol=1e-7)
    want = {"quadratic": "stop_loss", "converged_start": "stop_loss", "plateau": "plateau",
            "cap": "max_iter"}[case]
    assert out.reason == want
    if case == "converged_start":
        assert int(out.n_iters) == 1
        assert float(out.se3.abs().max()) == 0.0
    if case == "quadratic":
        assert float(out.loss) < 1e-3 and int(out.n_iters) < 5000


@pytest.mark.parametrize("check_every", [1, 7, 1000])
def test_host_reads_do_not_change_the_result(check_every, monkeypatch):
    """The flag read every 1, 7 or 1000 iterations: the same stop iteration
    and the same bits as the default cadence (the carry freezes)."""
    _, lr, max_iter, stop_loss, plateau_after, patience = CASES["plateau"]
    _, tloss = _loss_pair("plateau")
    kw = dict(lr=lr, max_iter=max_iter, stop_loss=stop_loss, plateau_after=plateau_after,
              patience=patience, device="cpu")
    a = ttt.test_time_pose_optim(tloss, lambda it: None, **kw)
    monkeypatch.setattr(ttt, "CHECK_EVERY", check_every)
    b = ttt.test_time_pose_optim(tloss, lambda it: None, **kw)
    assert int(a.n_iters) == int(b.n_iters)
    assert torch.equal(a.se3, b.se3) and torch.equal(a.loss, b.loss)


def test_draws_are_called_per_iteration():
    """draw(it) is called once per iteration run, in order, and its value
    reaches loss_fn."""
    seen = []

    def loss_fn(se3, d):
        seen.append(d)
        return ((se3 - torch.from_numpy(TARGET)) ** 2).sum()

    out = ttt.test_time_pose_optim(loss_fn, lambda it: it, lr=1e-2, max_iter=40,
                                   stop_loss=0.0, device="cpu")
    assert int(out.n_iters) == 40 and seen[:40] == list(range(40))


# --- make_ngp_pose_loss at the JAX suite's shape -------------------------------

H = W = 24
SCALE, OFF = 0.33, 0.5


@pytest.fixture(scope="module")
def trained():
    """The JAX suite's trained field (4 views of the detail scene at 24^2,
    4-level brick3, n_coarse 32, n_compact 8; 8 blocks of 4 steps), and the
    port's model and grid loaded from it."""
    from myc_nerfs_tpu.data.synthetic import make_detail_scene
    from myc_nerfs_tpu.geom import rays as jrays
    from myc_nerfs_tpu.models import ngp as jngp
    from myc_nerfs_tpu.render.ngp_render import NGPRenderConfig as JRC
    from myc_nerfs_tpu.train.ngp_trainer import NGPTrainConfig as JTC, NGPTrainer as JTr
    from myc_nerfs_tpu_torch.core.bridge import load_ngp_params, occupancy_from_numpy
    from myc_nerfs_tpu_torch.models import ngp as tngp
    from myc_nerfs_tpu_torch.render.ngp_render import NGPRenderConfig as TRC
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainConfig as TTC, NGPTrainer as TTr

    scene = make_detail_scene(n_views=4, H=H, W=W)
    c, r = jrays.get_center_and_ray(scene.poses, scene.intr, H, W)
    d = r / jnp.linalg.norm(r, axis=-1, keepdims=True)
    o = np.asarray((c * SCALE + OFF).reshape(-1, 3))
    dd = np.asarray(d.reshape(-1, 3))
    rgb = np.asarray(scene.images.reshape(-1, 3))
    grid = dict(n_levels=4, log2_hashmap_size=12, desired_resolution=64.0)
    rkw = dict(aabb_scale=1, n_coarse=32, n_samples=16, n_compact=8, fused_march=True,
               compact_source="grid")
    tkw = dict(lr=1e-2, n_rays_per_batch=128, target_batch_size=1 << 11,
               n_grid_uniform=1 << 11, n_grid_nonuniform=0, update_den_freq=4)
    jt = JTr(jngp.NGPModelConfig(grid=jngp.HashGridConfig(**grid), grid_impl="brick3"),
             JRC(**rkw), JTC(**tkw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    for _ in range(8):
        key, k1, k2 = jax.random.split(key, 3)
        jt.state = jt.state._replace(occ=jt.grid_update(jt.state.occ, jt.state.params, k1))
        ids = rng.integers(0, o.shape[0], (4, 128))
        jt.train_block(o[ids], dd[ids], rgb[ids], k2)
    tt = TTr(tngp.NGPModelConfig(grid=tngp.HashGridConfig(**grid), grid_impl="brick3"),
             TRC(**rkw), TTC(**tkw), torch.Generator().manual_seed(0), device="cpu")
    load_ngp_params(tt.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
    tt.state = tt.state._replace(occ=occupancy_from_numpy(
        jax.tree_util.tree_map(np.asarray, jt.state.occ._asdict())))
    return scene, jt, tt


def _losses(trained, view=0, n_rays=256):
    from myc_nerfs_tpu_torch.evaluation.test_time_optim import make_ngp_pose_loss as tmake

    scene, jt, tt = trained
    jl = jtt.make_ngp_pose_loss(jt.occ_cfg, jt.rcfg, jt.model.apply, jt.state.params,
                                jt.state.occ, scene.poses[view], scene.intr[view],
                                scene.images[view], H, W, n_rays=n_rays, world_scale=SCALE,
                                world_offset=OFF, density_apply=jt.model.density_raw)
    tl = tmake(tt.occ_cfg, tt.rcfg, tt.model, tt.state.occ,
               torch.from_numpy(np.array(scene.poses[view])),
               torch.from_numpy(np.array(scene.intr[view])),
               torch.from_numpy(np.array(scene.images[view])), H, W, world_scale=SCALE,
               world_offset=OFF, density_apply=tt.model.density_raw)
    return jl, tl


def _idx(key, n_rays=256):
    return torch.from_numpy(np.array(jax.random.randint(key, (n_rays,), 0, H * W)))


@pytest.mark.parametrize("se3", ["zero", "perturbed"])
def test_ngp_pose_loss_and_gradient_match_jax(trained, se3):
    """The loss (rtol 1e-5) and d loss / d se3 (atol 2e-3 of the largest
    component, f32 through a march, an SH encode and two MLPs) at se3 = 0
    (the JAX suite's point) and at a perturbed pose, on the JAX key's
    pixels. The gradient flows (the JAX suite's "pose grads flow through
    march"), the field's parameters get none and stay trainable."""
    jl, tl = _losses(trained)
    _, _, tt = trained
    x = (np.zeros((1, 6), np.float32) if se3 == "zero" else
         np.asarray([[0.01, -0.02, 0.015, 0.02, 0.01, -0.015]], np.float32))
    k = jax.random.PRNGKey(2)
    l0, g0 = jax.value_and_grad(jl)(jnp.asarray(x), k)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tl(xt, _idx(k))
    (g,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(float(loss.detach()), float(l0), rtol=1e-5)
    g, g0 = g.numpy(), np.asarray(g0)
    assert np.abs(g0).sum() > 0 and np.isfinite(g).all()
    np.testing.assert_allclose(g, g0, rtol=0, atol=2e-3 * np.abs(g0).max())
    assert all(p.grad is None and p.requires_grad for p in tt.model.param_list())


def test_ngp_test_time_optim_matches_jax(trained):
    """30 iterations of test_time_pose_optim through make_ngp_pose_loss from
    a perturbed pose of view 1, the port fed the JAX loop's pixel draws
    (its key chain replayed): the same iterations; the best loss within
    rtol 5e-3 and the best se3 within 5e-2 of its scale. The two
    trajectories part by a few percent: a sample's validity decision
    flips with the f32 rounding of its position now and then (one draw in
    three moves the gradient by ~2% in the test above), and Adam
    normalises each step, so such a difference moves the pose by up to
    the learning rate. The translation stays within 1e-5 of 0 in both: its
    gradient is 0 up to rounding, since with const_dt the step size is the
    constant floor here and the grid encode stops the position gradient."""
    from myc_nerfs_tpu.geom import lie as jlie
    from myc_nerfs_tpu.geom import pose as jpose

    scene, jt, tt = trained
    from myc_nerfs_tpu_torch.evaluation.test_time_optim import make_ngp_pose_loss as tmake

    start = jpose.compose_pair(jlie.se3_to_SE3(jnp.asarray([[0.02, -0.01, 0.01, 0.03, -0.02,
                                                            0.01]]))[0], scene.poses[1])
    jl = jtt.make_ngp_pose_loss(jt.occ_cfg, jt.rcfg, jt.model.apply, jt.state.params,
                                jt.state.occ, start, scene.intr[1], scene.images[1], H, W,
                                n_rays=128, world_scale=SCALE, world_offset=OFF,
                                density_apply=jt.model.density_raw)
    tl = tmake(tt.occ_cfg, tt.rcfg, tt.model, tt.state.occ,
               torch.from_numpy(np.array(start)), torch.from_numpy(np.array(scene.intr[1])),
               torch.from_numpy(np.array(scene.images[1])), H, W, world_scale=SCALE,
               world_offset=OFF, density_apply=tt.model.density_raw)
    key = jax.random.PRNGKey(7)
    kw = dict(lr=3e-3, max_iter=30, stop_loss=7e-4)
    ref = jtt.test_time_pose_optim(jl, key, **kw)
    keys, k = [], key
    for _ in range(30):
        k, sub = jax.random.split(k)
        keys.append(sub)
    out = ttt.test_time_pose_optim(tl, lambda it: _idx(keys[it], 128), device="cpu", **kw)
    assert int(out.n_iters) == int(ref.n_iters) == 30
    np.testing.assert_allclose(float(out.loss), float(ref.loss), rtol=5e-3)
    ref_se3 = np.asarray(ref.se3)
    np.testing.assert_allclose(out.se3.numpy(), ref_se3, rtol=0,
                               atol=5e-2 * np.abs(ref_se3).max())
    assert float(out.se3[0, 3:].abs().max()) < 1e-5 and float(np.abs(ref_se3[0, 3:]).max()) < 1e-5


def test_plain_path_stops_the_position_gradient(trained):
    """The same pose gradient through the model's plain path
    (use_encode_kernel and use_fully off: paired_encode_reference and the
    reference MLP) as through its kernels' path (their CPU versions):
    paired_encode_reference passes no gradient to the positions, as the
    encode's autograd function and the JAX package's stop_pos_grad (atol
    1e-7 of the largest component)."""
    jl, tl = _losses(trained)
    _, _, tt = trained
    idx = _idx(jax.random.PRNGKey(3))
    x = torch.tensor([[0.01, -0.02, 0.015, 0.02, 0.01, -0.015]], requires_grad=True)
    (g_main,) = torch.autograd.grad(tl(x, idx), x)
    tt.model.use_encode_kernel, tt.model.net.use_fully = False, False
    try:
        (g_plain,) = torch.autograd.grad(tl(x, idx), x)
    finally:
        tt.model.use_encode_kernel, tt.model.net.use_fully = True, True
    np.testing.assert_allclose(g_plain.numpy(), g_main.numpy(), rtol=0,
                               atol=1e-7 * float(g_main.abs().max()))
