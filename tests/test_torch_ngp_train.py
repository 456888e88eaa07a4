"""Port parity of NGP training: the learning-rate schedule, Adam, the
parameter-update tail (clip, fp16 gradient emulation, non-finite skip),
the EMA blend, three whole train steps, and the batch adaptation of
myc_nerfs_tpu_torch.train.ngp_trainer against myc_nerfs_tpu's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.render import ngp_render as jnr
from myc_nerfs_tpu.render import occupancy as jocc
from myc_nerfs_tpu.train import ngp_trainer as jtr
from myc_nerfs_tpu_torch.core.bridge import (load_ngp_params, occupancy_from_numpy,
                                             param_leaves)
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.render import occupancy as tocc
from myc_nerfs_tpu_torch.train import ngp_trainer as ttr

torch.set_num_threads(1)

DEMO_GRID = dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0)


def test_lr_schedule_matches_optax():
    """ExpDecay steps and the warmup ramp at the boundaries (rtol 1e-6)."""
    for kw in ({}, {"warmup_steps": 100}):
        jcfg = jtr.NGPTrainConfig(**kw)
        tcfg = ttr.NGPTrainConfig(**kw)
        steps = np.asarray([0, 1, 50, 99, 19999, 20000, 29999, 30000, 45000, 80000],
                           np.int32)
        ref = np.asarray(jax.vmap(jtr.make_lr_schedule(jcfg))(jnp.asarray(steps)))
        out = ttr.make_lr_schedule(tcfg)(torch.from_numpy(steps)).numpy()
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=1e-6)


UPDATE_CASES = {"adam": {}, "clip": {"clip_grad_norm": 0.5},
                "fp16_grads": {"fp16_grads": True}, "skip": {"skip_nonfinite": True},
                "skip_fp16_warmup": {"skip_nonfinite": True, "fp16_grads": True,
                                     "warmup_steps": 3},
                "skip_clip": {"skip_nonfinite": True, "clip_grad_norm": 0.5}}


# skip_clip is f32 only: with bf16 params the JAX lax.cond raises (the clip
# promotes the new moments to f32, the kept ones are bf16)
@pytest.mark.parametrize("name,bf16", [(n, b) for n in UPDATE_CASES for b in (False, True)
                                       if not (b and n == "skip_clip")])
def test_apply_param_update_matches_jax(name, bf16):
    """Four updates of a three-leaf tree (the last two leaves bf16 in the
    bf16 case, like the NGP MLP weights beside f32 tables), with gradients
    over nine decades and a NaN in the third: params, both moments and the
    step count after each update, through the ExpDecay boundaries (start 1,
    interval 2). f32: rtol 1e-5 (pow and the EMA's debias in another
    library). bf16: four ulps (2^-6) of the value plus the learning rate:
    XLA may fuse a bf16 chain and round once where the port rounds per
    operation, and an update one ulp off carries into the next steps.
    With the clip, JAX promotes a clipped bf16 gradient, and with it the
    moments, to f32; so does the port: every leaf's dtype must agree. The
    global norm over bf16 leaves (each leaf's sum of squares in bf16, as
    optax.global_norm) equals eager JAX's exactly, but the jitted update
    fuses the squares into the sum and moves the norm by up to ~6e-4, and
    with it every clipped gradient: rtol 2e-3 for the f32 leaves there."""
    kw = UPDATE_CASES[name]
    dtypes = ["float32", "bfloat16", "bfloat16"] if bf16 else ["float32"] * 3
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (16,), (4, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jcfg = jtr.NGPTrainConfig(decay_start=1, decay_interval=2, **kw)
    tcfg = ttr.NGPTrainConfig(decay_start=1, decay_interval=2, **kw)
    tx = jtr.make_optimizer(jcfg)
    jp = [jnp.asarray(a, d) for a, d in zip(p0, dtypes)]
    js = jtr.NGPTrainState(params=jp, opt_state=tx.init(jp), occ=None,
                           step=jnp.zeros((), jnp.int32))
    tp = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip(p0, dtypes)]
    topt = ttr.init_adam(tp)
    update = jax.jit(lambda s, g: jtr.apply_param_update(jcfg, tx, s, g))
    for k in range(4):
        g = [(rng.standard_normal(s) * 10 ** rng.uniform(-6, 3, s)).astype(np.float32)
             for s in shapes]
        if k == 2:
            g[1][3] = np.nan
        js = update(js, [jnp.asarray(a, d) for a, d in zip(g, dtypes)])
        count = int(topt.count)
        tp, topt, finite = ttr.apply_param_update(
            tcfg, tp, topt, k, [torch.from_numpy(a).to(getattr(torch, d))
                                for a, d in zip(g, dtypes)])
        assert int(topt.count) == int(js.opt_state[0].count) == int(js.opt_state[1].count)
        if tcfg.skip_nonfinite:  # a skipped step does not count
            assert bool(finite) == (int(topt.count) == count + 1)
            assert bool(finite) or k >= 1
        pairs = (list(zip(tp, js.params)) + list(zip(topt.mu, js.opt_state[0].mu))
                 + list(zip(topt.nu, js.opt_state[0].nu)))
        for i, (a, b) in enumerate(pairs):
            assert str(a.dtype).split(".")[-1] == str(b.dtype), (k, i)
            a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
            if dtypes[i % 3] == "float32":
                rtol = 2e-3 if bf16 and "clip_grad_norm" in kw else 1e-5
                np.testing.assert_allclose(a, b, rtol=rtol, equal_nan=True,
                                           atol=1e-7 * np.nanmax(np.abs(b), initial=1.0))
            else:
                tol = 2.0 ** -6 * (np.abs(b) + (jcfg.lr if i < 3 else 0.0))
                with np.errstate(invalid="ignore"):  # inf - inf where both overflowed
                    ok = (np.abs(a - b) <= tol) | (a == b) | (np.isnan(a) & np.isnan(b))
                assert ok.all(), (k, i, np.nanmax(np.abs(a - b)))


def test_ema_step_matches_jax():
    """The debiased EMA blend at steps 0, 1, 7 and 1000, f32 and bf16
    params (rtol 1e-6 in f32; bf16 rounds the f32 blend once, one ulp)."""
    cfg_j, cfg_t = jtr.NGPTrainConfig(ema_decay=0.95), ttr.NGPTrainConfig(ema_decay=0.95)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((64,)).astype(np.float32)
    v = rng.standard_normal((64,)).astype(np.float32)
    for step in (0, 1, 7, 1000):
        for jd, td, rtol in ((jnp.float32, torch.float32, 1e-6),
                             (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)):
            ref = jtr.ema_step(cfg_j, [jnp.asarray(p, jd)], [jnp.asarray(v, jd)],
                               jnp.asarray(step, jnp.int32))[0]
            out = ttr.ema_step(cfg_t, [torch.from_numpy(p).to(td)],
                               [torch.from_numpy(v).to(td)], step)[0]
            assert out.dtype == td
            np.testing.assert_allclose(out.float().numpy(),
                                       np.asarray(ref.astype(jnp.float32)),
                                       rtol=rtol, atol=1e-7)


def test_ladder_floor_and_batch_adaptation():
    """_ladder_floor on and between its rungs, and _update_batch_rays from
    the same measured sample counts: equal to the JAX package's."""
    for r in [1, 127, 128, 129, 1000, 1279, 1280, 1536, 1792, 2047, 2048,
              5000, 262144, 300000]:
        assert ttr._ladder_floor(r) == jtr._ladder_floor(r)
    jt = jtr.NGPTrainer.__new__(jtr.NGPTrainer)
    tt = ttr.NGPTrainer.__new__(ttr.NGPTrainer)
    for t, cfg in ((jt, jtr.NGPTrainConfig()), (tt, ttr.NGPTrainConfig())):
        t.cfg = cfg
        t.n_rays_per_batch = 4096
    for total, count in ((16 * 4096 * 50.0, 16), (16 * 4096 * 3.5, 16),
                         (0.0, 16), (1e9, 1), (5e5, 3)):
        jt._measured_samples, jt._measure_count = jnp.asarray(total), count
        tt._measured_samples, tt._measure_count = torch.tensor(total), count
        jt._update_batch_rays()
        tt._update_batch_rays()
        assert tt.n_rays_per_batch == jt.n_rays_per_batch
        assert tt._measure_count == 0


G = 32  # a small occupancy grid: 3 cascades of 32^3 cells


def _trainers(grid_impl):
    """A JAX and a port trainer with the same params (through the bridge),
    the same structured occupancy grid and fresh Adam states."""
    rkw = dict(n_coarse=64, n_samples=16, n_compact=16, near_distance=0.05)
    tkw = dict(lr=1e-2, eps=1e-6, n_grid_uniform=64, n_grid_nonuniform=64)
    jt = jtr.NGPTrainer(jngp.NGPModelConfig(grid=jngp.HashGridConfig(**DEMO_GRID),
                                            grid_impl=grid_impl),
                        jnr.NGPRenderConfig(**rkw), jtr.NGPTrainConfig(**tkw),
                        jax.random.PRNGKey(0))
    tt = ttr.NGPTrainer(tngp.NGPModelConfig(grid=tngp.HashGridConfig(**DEMO_GRID),
                                            grid_impl=grid_impl),
                        tnr.NGPRenderConfig(**rkw), ttr.NGPTrainConfig(**tkw),
                        torch.Generator().manual_seed(0), device="cpu")
    okw = dict(grid_size=G, n_cascades=3, max_cascade=0)
    jt.occ_cfg, tt.occ_cfg = jocc.OccupancyConfig(**okw), tocc.OccupancyConfig(**okw)
    u = np.random.default_rng(0).uniform(0, 1, (3, G, G, G)).astype(np.float32)
    grid = np.where(u > 0.5, 0.08 * u, 0.0).astype(np.float32)
    bits, mean = jocc.update_bitfield(jt.occ_cfg, jnp.asarray(grid))
    occ = jocc.OccupancyState(density_grid=jnp.asarray(grid), bitfield=bits,
                              mean_density=mean, ema_step=jnp.zeros((), jnp.int32))
    jt.state = jt.state._replace(occ=occ)
    jt._step_fn = jt._build_step()  # rebuilt around the small grid
    load_ngp_params(tt.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
    tt.state = tt.state._replace(occ=occupancy_from_numpy(
        jax.tree_util.tree_map(np.asarray, occ._asdict())))
    return jt, tt


@pytest.mark.parametrize("grid_impl", ["brick3", "hash"])
def test_three_train_steps_match_jax(grid_impl):
    """Three f32 steps of the port (train_block, one step each) against the
    JAX NGPTrainer._step_fn on the same rays, targets, per-ray backgrounds
    and JAX-drawn march jitter, from the same params and grid.

    Loss rtol 1e-5, PSNR within 1e-4 dB, valid samples equal to 0.5%. The
    port's gradient equals the JAX one run eagerly to 1e-6 of each
    tensor's scale, but the jitted _step_fn sums the table's scatter-add in
    another order and moves single hash-table gradients by up to 1e-2 of
    the scale. So both Adam moments must agree within 5e-2 of each
    tensor's scale everywhere and within 1e-4 on 98% of it; params within
    1e-6 + 1e-4 |p| on 99% of each tensor and everywhere within the
    learning rate. Adam's eps is 1e-6 here, not 1e-15: with 1e-15 an
    element whose gradient is rounding noise (a cancelling sum) still moves
    by the whole learning rate, in a direction the noise sets."""
    jt, tt = _trainers(grid_impl)
    rng = np.random.default_rng(1)
    N = 256
    for k in range(3):
        o = rng.standard_normal((N, 3))
        o = 0.5 + o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
        d = rng.uniform(0, 1, (N, 3)) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
        tgt = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        bg = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        key = jax.random.PRNGKey(10 + k)
        xi = np.array(jax.random.uniform(key, (N, 1)))  # as _place_samples draws it
        jt.state, jm = jt._step_fn(jt.state, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tgt), jnp.asarray(bg), key)
        tm = tt.train_block(o[None], d[None], tgt[None], bg=bg[None], xi=xi[None])
        np.testing.assert_allclose(float(tm["loss"][0]), float(jm["loss"]), rtol=1e-5)
        assert abs(float(tm["psnr"][0]) - float(jm["psnr"])) < 1e-4
        assert abs(int(tm["n_samples"][0]) - int(jm["n_samples"])) <= 0.005 * int(jm["n_samples"])
        assert int(jm["n_samples"]) > N  # the grid is neither empty nor full
        assert tt.state.step == int(jt.state.step) == k + 1
        assert int(tt.state.opt_state.count) == int(jt.state.opt_state[0].count) == k + 1
        jopt = jt.state.opt_state[0]
        for mine, theirs in ((tt.state.opt_state.mu, jopt.mu), (tt.state.opt_state.nu, jopt.nu)):
            for a, b in zip(mine, param_leaves(tt.model, theirs)):
                a, b = a.numpy(), np.asarray(b)
                err = np.abs(a - b) / max(np.abs(b).max(), 1e-30)
                assert err.max() <= 5e-2 and np.mean(err > 1e-4) <= 0.02
        for a, b in zip(tt.model.param_list(), param_leaves(tt.model, jt.state.params)):
            a, b = a.detach().numpy(), np.asarray(b)
            diff = np.abs(a - b)
            assert np.mean(diff > 1e-6 + 1e-4 * np.abs(b)) <= 0.01
            assert diff.max() <= tt.cfg.lr


def test_train_step_cadence():
    """train_step, the one-step entry point: a grid update before the
    first step of every update_den_freq cadence and the batch adaptation
    after its last, as the JAX package's train_step; the march jitter and
    the grid samples come from the generator."""
    tt = ttr.NGPTrainer(tngp.NGPModelConfig(grid=tngp.HashGridConfig(**DEMO_GRID)),
                        tnr.NGPRenderConfig(n_coarse=32, n_compact=8, near_distance=0.05),
                        ttr.NGPTrainConfig(update_den_freq=4, n_rays_per_batch=64,
                                           target_batch_size=1 << 10,
                                           n_grid_uniform=256, n_grid_nonuniform=256),
                        torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    o = np.full((64, 3), 0.5, np.float32) + rng.uniform(-0.1, 0.1, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tgt = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    for k in range(6):
        m = tt.train_step(o, d, tgt, generator=gen)
        assert torch.isfinite(m["loss"]) and tt.state.step == k + 1
        assert int(tt.state.occ.ema_step) == k // 4 + 1
        assert tt._measure_count == (k + 1) % 4
    assert tt.host_step == 6 and tt.n_rays_per_batch != 64
