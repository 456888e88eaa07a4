"""Port parity of the NeRF/BARF/GARF trainer: the learning-rate schedules,
the refined-pose composition, three whole train steps of nerf, barf (pose
noise, c2f, pose warmup), garf (the correction gate on and off) and fine
sampling (with density noise) against the JAX ``_make_step_raw`` on the same
draws (parameters, se3_refine and both optimizer states), the validation
render, and the checkpoint both ways: the JAX ``restore_checkpoint`` reads
the port's file and the port reads the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from myc_nerfs_tpu.core import checkpoint as jck
from myc_nerfs_tpu.data import synthetic as jsyn
from myc_nerfs_tpu.train import nerf_trainer as jnt
from myc_nerfs_tpu_torch.core import checkpoint as tck
from myc_nerfs_tpu_torch.core.bridge import nerf_params_from_numpy, param_leaves
from myc_nerfs_tpu_torch.train import nerf_trainer as tnt

torch.set_num_threads(1)

N_VIEWS, SIZE = 4, 20
ARCH = dict(widths_feat=(32,) * 4, widths_rgb=(16, 3), skip=(2,), posenc_L3D=4,
            posenc_Lview=2, depth_range=(1.5, 4.5), sample_intvs=16, rand_rays=96,
            lr=5e-3, lr_end=1e-3, max_iter=10)
CASES = {
    "nerf": dict(model="nerf"),
    "barf": dict(model="barf", refine_pose=True, camera_noise=0.1, c2f=(0.1, 0.5),
                 lr_pose=3e-3, lr_pose_end=1e-4, warmup_pose=2),
    "garf_gated": dict(model="garf", refine_pose=True, camera_noise=0.05,
                       start_pose_correct_iter=2, skip=(3,)),
    "garf": dict(model="garf", refine_pose=True, camera_noise=0.05, skip=(3,)),
    "fine": dict(model="nerf", fine_sampling=True, sample_intvs_fine=8,
                 density_noise_reg=0.5, setbg_opaque=True, bgcolor=0.3),
}


@pytest.fixture(scope="module")
def scene():
    s = jsyn.make_scene(n_views=N_VIEWS, H=SIZE, W=SIZE, textured=True)
    return tuple(np.array(x) for x in (s.images, s.poses, s.intr))


def test_schedules_match_optax():
    """exp_schedule against optax.exponential_decay, linear_warmup against
    optax.linear_schedule and the trainer's pose schedule with warmup
    against the JAX one, at counts 0, 1, mid-run and past max_iter (rtol
    1e-6: f32 pow in two libraries)."""
    counts = np.array([0, 1, 2, 5, 99, 1000, 199999, 200000, 250000], np.int32)
    tc = torch.from_numpy(counts)
    for lr, end, n in ((5e-4, 1e-4, 200000), (3e-3, 1e-5, 200000), (1e-4, 5e-5, 1000)):
        ref = jax.vmap(optax.exponential_decay(lr, 1, (end / lr) ** (1.0 / n)))(counts)
        out = tnt.exp_schedule(lr, end, n)(tc)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(tnt.linear_warmup(1000)(tc).numpy(),
                               jax.vmap(optax.linear_schedule(0.0, 1.0, 1000))(counts),
                               rtol=1e-6)
    kw = dict(lr_pose=1e-3, lr_pose_end=1e-5, warmup_pose=1000, max_iter=200000)
    _, jpose = jnt.make_optimizers(jnt.NeRFTrainConfig(**kw))
    _, tpose = tnt.make_schedules(tnt.NeRFTrainConfig(**kw))
    # the JAX pose optimizer's learning rate at each count: the update of a
    # unit gradient from a fresh state is -lr (Adam's first step is sign(g))
    for c in (0, 1, 500, 999, 1000, 5000):
        st = jpose.init(jnp.zeros(()))
        st = (st[0]._replace(count=jnp.int32(c)), st[1]._replace(count=jnp.int32(c)))
        if c:
            st = (st[0]._replace(mu=jnp.float32(1.0 - 0.9 ** c), nu=jnp.float32(1.0 - 0.999 ** c)),
                  st[1])
        up, _ = jpose.update(jnp.ones(()), st)
        np.testing.assert_allclose(float(tpose(torch.tensor(c, dtype=torch.int32))), -float(up),
                                   rtol=2e-5)


def _pair(name, scene):
    """(JAX cfg, step, state) and (port cfg, step, state) from the same
    initial weights and pose noise."""
    images, poses, intr = scene
    kw = {**ARCH, **CASES[name]}
    jcfg = jnt.NeRFTrainConfig(**kw, mlp_tile=False)
    tcfg = tnt.NeRFTrainConfig(**kw)
    _, js = jnt.init_state(jcfg, jax.random.PRNGKey(0), N_VIEWS)
    jstep = jax.jit(jnt._make_step_raw(jcfg, jnt.build_model(jcfg), jnp.asarray(images),
                                       jnp.asarray(poses), jnp.asarray(intr)))
    ts = tnt.init_state(tcfg, torch.Generator().manual_seed(1), N_VIEWS, "cpu")
    nerf_params_from_numpy(ts.params, jax.tree_util.tree_map(np.asarray, js.params))
    ts = ts._replace(pose_noise=torch.from_numpy(np.array(js.pose_noise)))
    tstep = tnt.make_train_step(tcfg, torch.from_numpy(images), torch.from_numpy(poses),
                                torch.from_numpy(intr))
    return (jcfg, jstep, js), (tcfg, tstep, ts)


def _draws(cfg, key):
    """The draws of the JAX step for ``key``, as _make_step_raw makes them."""
    k_idx, k_depth, k_noise = jax.random.split(key, 3)
    R = cfg.rand_rays // N_VIEWS
    shape = (N_VIEWS, R)
    noise = noise_fine = None
    if cfg.density_noise_reg:
        noise = torch.from_numpy(np.array(jax.random.normal(k_noise, shape + (cfg.sample_intvs,))))
        if cfg.fine_sampling:
            n = cfg.sample_intvs + cfg.sample_intvs_fine
            noise_fine = torch.from_numpy(np.array(jax.random.normal(k_noise, shape + (n,))))
    return tnt.StepDraws(
        ray_idx=torch.from_numpy(np.array(jax.random.randint(k_idx, (R,), 0, SIZE * SIZE))),
        depth=torch.from_numpy(np.array(jax.random.uniform(
            k_depth, shape + (cfg.sample_intvs, 1)))),
        noise=noise, noise_fine=noise_fine)


def _check_adam(mine, theirs, leaves_of):
    """Both moments within 2e-3 of each tensor's scale and the counts equal."""
    assert int(mine.count) == int(theirs[0].count) == int(theirs[1].count)
    for ms, ts in ((mine.mu, theirs[0].mu), (mine.nu, theirs[0].nu)):
        for a, b in zip(ms, leaves_of(ts)):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_train_steps_match_jax(name, scene, tmp_path):
    """Three steps on the JAX-drawn ray indices, depth jitter and density
    noise, each from the JAX state of that step (written by the JAX
    save_checkpoint, read by the port's restore_checkpoint), so that each
    step's comparison holds one step's rounding: a second Adam step
    amplifies a first step's rounding where its momentum cancels, and the
    two runs part.

    Loss and PSNR rtol 1e-5 (measured <= 3e-6). Adam's moments within 2e-3
    of each tensor's scale: the gradients agree to ~1e-6 of their scale for
    nerf and barf, to ~7e-4 for garf (the gaussian's 1/sigma^2 = 100 scales
    each pre-activation's rounding) and ~1.1e-3 with fine sampling (fine
    depths placed by the coarse pdf). Parameters and se3_refine: within
    lr / 100 on 95% of each tensor and within lr / 5 everywhere (measured
    at most lr / 10): Adam's step is ~lr * m / sqrt(v), and where a
    gradient is rounding noise (a cancelling sum) that ratio, and so the
    step, differs between the libraries."""
    (jcfg, jstep, js), (tcfg, tstep, ts) = _pair(name, scene)
    path = str(tmp_path / "jax.ckpt")
    moved = False
    for k in range(3):
        jck.save_checkpoint(path, js, step=k)
        ts, _ = tck.restore_checkpoint(path, ts)
        key = jax.random.PRNGKey(10 + k)
        js, jm = jstep(js, key)
        ts, tm = tstep(ts, _draws(tcfg, key))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
        assert int(ts.step) == int(js.step) == k + 1 and ts.step.dtype == torch.int32
        model = ts.params
        pairs = list(zip(model.param_list(), param_leaves(model, jax.tree_util.tree_map(
            np.asarray, js.params))))
        pairs.append((ts.se3_refine, np.asarray(js.se3_refine)))
        for a, b in pairs:
            lr = tcfg.lr_pose if a is ts.se3_refine else tcfg.lr
            diff = np.abs(a.detach().numpy() - np.asarray(b))
            assert np.mean(diff > lr / 100) <= 0.05 and diff.max() <= lr / 5, (k, diff.max())
        _check_adam(ts.opt_state, js.opt_state,
                    lambda tree: param_leaves(model, jax.tree_util.tree_map(np.asarray, tree)))
        _check_adam(ts.opt_state_pose, js.opt_state_pose, lambda t: [np.asarray(t)])
        np.testing.assert_array_equal(ts.pose_noise.numpy(), np.asarray(js.pose_noise))
        moved = moved or bool(ts.se3_refine.abs().max() > 0)
        # GARF's gate: no correction before start_pose_correct_iter; BARF's
        # warmup: a pose rate of 0 at count 0
        first = max(tcfg.start_pose_correct_iter, 1 if tcfg.warmup_pose else 0)
        assert moved == (tcfg.refine_pose and k >= first)


@pytest.mark.parametrize("name", ["garf_gated", "fine"])
def test_compose_and_validation_render_match_jax(name, scene):
    """compose_refined_pose before and after the gate (rtol 1e-5, atol
    1e-5), and render_validation (the fine graph with fine sampling) of the
    initial weights on view 0: rtol 1e-5, atol 1e-5, and for garf atol 2e-4
    (measured 8.9e-5: the sigma 0.1 gaussians scale f32 rounding 100x per
    layer's input)."""
    images, poses, intr = scene
    (jcfg, _, js), (tcfg, _, ts) = _pair(name, scene)
    se3 = np.random.default_rng(3).standard_normal((N_VIEWS, 6)).astype(np.float32) * 0.05
    for step in (0, 2, 3):
        j = js._replace(se3_refine=jnp.asarray(se3), step=jnp.int32(step))
        t = ts._replace(se3_refine=torch.from_numpy(se3), step=torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(tnt.compose_refined_pose(tcfg, t, torch.from_numpy(poses)).numpy(),
                                   jnt.compose_refined_pose(jcfg, j, jnp.asarray(poses)),
                                   rtol=1e-5, atol=1e-5)
    rgb_j, depth_j = jnt.render_validation(jcfg, jnt.build_model(jcfg), js.params,
                                           jnp.asarray(poses[0]), jnp.asarray(intr[0]), SIZE,
                                           SIZE, chunk=128)
    rgb_t, depth_t = tnt.render_validation(tcfg, ts.params, torch.from_numpy(poses[0]),
                                           torch.from_numpy(intr[0]), SIZE, SIZE, chunk=128)
    atol = 2e-4 if tcfg.model == "garf" else 1e-5
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(depth_t.numpy(), depth_j, rtol=1e-5, atol=atol * 10)


@pytest.mark.parametrize("name", ["barf", "fine"])
def test_checkpoint_both_ways(name, scene, tmp_path):
    """The port's checkpoint of a trained state restores in the JAX package
    (restore_checkpoint into its NeRFTrainState: every leaf equal), a JAX
    checkpoint restores in the port (every tensor equal, dtypes kept), and
    keep_snapshot writes model/<step>.ckpt with the same bytes."""
    (jcfg, jstep, js), (tcfg, tstep, ts) = _pair(name, scene)
    for k in range(2):
        key = jax.random.PRNGKey(20 + k)
        js, _ = jstep(js, key)
        ts, _ = tstep(ts, _draws(tcfg, key))
    path = str(tmp_path / "model.ckpt")
    tck.save_checkpoint(path, ts, step=2, keep_snapshot=True)
    assert open(path, "rb").read() == open(tmp_path / "model" / "2.ckpt", "rb").read()
    _, fresh_j = jnt.init_state(jcfg, jax.random.PRNGKey(5), N_VIEWS)
    got, meta = jck.restore_checkpoint(path, fresh_j)
    assert meta == {"step": 2}
    mine = dict(params=ts.params.param_list(), se3=[ts.se3_refine], noise=[ts.pose_noise])
    theirs = dict(params=param_leaves(ts.params, jax.tree_util.tree_map(np.asarray, got.params)),
                  se3=[got.se3_refine], noise=[got.pose_noise])
    for k in mine:
        for a, b in zip(mine[k], theirs[k]):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert int(got.step) == 2 and int(got.opt_state[0].count) == 2
    np.testing.assert_array_equal(np.asarray(got.opt_state_pose[0].nu),
                                  ts.opt_state_pose.nu[0].numpy())

    jpath = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(jpath, js, step=2)
    fresh_t = tnt.init_state(tcfg, torch.Generator().manual_seed(7), N_VIEWS, "cpu")
    back, meta = tck.restore_checkpoint(jpath, fresh_t)
    assert meta == {"step": 2} and back.step.dtype == torch.int32 and int(back.step) == 2
    for a, b in zip(back.params.param_list(),
                    param_leaves(back.params, jax.tree_util.tree_map(np.asarray, js.params))):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for a, b in ((back.se3_refine, js.se3_refine), (back.pose_noise, js.pose_noise),
                 (back.opt_state_pose.mu[0], js.opt_state_pose[0].mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(back.opt_state.count) == 2 and len(back.opt_state.mu) == len(
        back.params.param_list())


def test_train_block_is_the_loop_of_steps(scene):
    """train_block over three draws equals three steps (bit for bit), with
    draws from draw_step's generator."""
    images, poses, intr = (torch.from_numpy(x) for x in scene)
    cfg = tnt.NeRFTrainConfig(**{**ARCH, **CASES["barf"]})
    step = tnt.make_train_step(cfg, images, poses, intr)
    gen = torch.Generator().manual_seed(3)
    draws = [tnt.draw_step(cfg, N_VIEWS, SIZE, SIZE, gen) for _ in range(3)]
    assert draws[0].ray_idx.shape == (cfg.rand_rays // N_VIEWS,)
    assert draws[0].depth.shape == (N_VIEWS, cfg.rand_rays // N_VIEWS, cfg.sample_intvs, 1)
    a = tnt.init_state(cfg, torch.Generator().manual_seed(0), N_VIEWS)
    b = tnt.init_state(cfg, torch.Generator().manual_seed(0), N_VIEWS)
    a, ma = tnt.train_block(step, a, draws)
    for d in draws:
        b, mb = step(b, d)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(a.se3_refine, b.se3_refine)
    for x, y in zip(a.params.param_list(), b.params.param_list()):
        assert torch.equal(x, y)
