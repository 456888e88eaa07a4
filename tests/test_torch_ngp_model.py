"""Port parity: SH encode, hash encode, brick3 encode and NGPModel of
myc_nerfs_tpu_torch against myc_nerfs_tpu, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.ops import brick_grid as jbg
from myc_nerfs_tpu.ops.sh import sh_encode as jax_sh_encode
from myc_nerfs_tpu_torch.core.bridge import load_ngp_params, ngp_params_to_numpy
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.ops import brick_grid as tbg
from myc_nerfs_tpu_torch.ops.sh import sh_encode

torch.set_num_threads(1)

# the demo_synthetic grid: 8 levels, 2^15, finest res 256 (dense and
# hashed levels, one brick3 group of three hashed levels)
DEMO_GRID = dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0)


def _positions(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)


def test_sh_encode():
    """Same polynomials in the same operation order (atol 1e-6 on values
    up to ~2.5)."""
    d = np.random.default_rng(0).standard_normal((500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jax_sh_encode(jnp.asarray(d), degree=4, pad_to=16))
    out = sh_encode(torch.from_numpy(d), degree=4, pad_to=16).numpy()
    assert out.shape == (500, 16)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_hash_encode_dense_and_hashed_levels():
    """Index math (dense row-major and the uint32 prime hash, emulated in
    int64) must pick the same corners: with O(1) table values, any wrong
    index shows at O(1); the lerp sums in another order (atol 1e-5)."""
    jcfg = jngp.HashGridConfig(n_levels=6, log2_hashmap_size=12,
                               desired_resolution=128.0)
    tcfg = tngp.HashGridConfig(n_levels=6, log2_hashmap_size=12,
                               desired_resolution=128.0)
    levels = jngp.compute_levels(jcfg)
    assert any(levels.dense) and not all(levels.dense)
    assert tngp.compute_levels(tcfg).__dict__ == levels.__dict__
    table = np.random.default_rng(1).uniform(
        -1, 1, (levels.n_params, 2)).astype(np.float32)
    pos = _positions(700, 2)
    ref = np.asarray(jngp.hash_encode(jnp.asarray(table), jnp.asarray(pos), jcfg))
    out = tngp.hash_encode(torch.from_numpy(table), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _brick_setup(seed):
    jcfg = jngp.HashGridConfig(**DEMO_GRID)
    tcfg = tngp.HashGridConfig(**DEMO_GRID)
    jl = jbg.compute_brick_levels(jcfg)
    jg = jbg.compute_level_groups(jl, group_size=3)
    tl = tbg.compute_brick_levels(tcfg)
    tg = tbg.compute_level_groups(tl, group_size=3)
    assert tl.__dict__ == jl.__dict__ and tg.groups == jg.groups
    assert any(len(m) == 3 for m in tg.groups) and any(tl.dense)
    rng = np.random.default_rng(seed)
    tables = [rng.uniform(-1, 1, (tl.n_bricks[m[-1]], len(m) * 2 * 128))
              .astype(np.float32) for m in tg.groups]
    return jcfg, tcfg, jl, jg, tl, tg, tables


def test_paired_encode_f32():
    """brick3 encode: dense f32 brick ids with a clip, hashed brick ids,
    the coarse members' window base, and the 8-vertex gather against JAX's
    128-lane selector matmuls (atol 1e-5 on O(1) features)."""
    jcfg, tcfg, jl, jg, tl, tg, tables = _brick_setup(3)
    pos = _positions(600, 4)
    pos[:5] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1], [0.25, 0.75, 1]]
    ref = np.asarray(jbg.paired_encode([jnp.asarray(t) for t in tables],
                                       jnp.asarray(pos), jcfg, jl, jg))
    out = tbg.paired_encode([torch.from_numpy(t) for t in tables],
                            torch.from_numpy(pos), tcfg, tl, tg)
    assert out.shape == (600, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_paired_encode_bf16_compute():
    """bf16 interpolation over f32 tables: the weights and products round
    to bf16 on both sides but the 8-term sums round at different points,
    so allow 3 bf16 ulps (2^-6) of the O(1) features."""
    jcfg, tcfg, jl, jg, tl, tg, tables = _brick_setup(5)
    pos = _positions(600, 6)
    ref = np.asarray(jbg.paired_encode([jnp.asarray(t) for t in tables],
                                       jnp.asarray(pos), jcfg, jl, jg,
                                       compute_dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    out = tbg.paired_encode([torch.from_numpy(t) for t in tables],
                            torch.from_numpy(pos), tcfg, tl, tg,
                            compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0 ** -6 * 2)


def _models(grid_impl, use_bf16, seed=0):
    jcfg = jngp.NGPModelConfig(grid=jngp.HashGridConfig(**DEMO_GRID),
                               grid_impl=grid_impl, use_bf16=use_bf16)
    tcfg = tngp.NGPModelConfig(grid=tngp.HashGridConfig(**DEMO_GRID),
                               grid_impl=grid_impl, use_bf16=use_bf16)
    jm = jngp.NGPModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    # O(1) tables so the encodings, not the +-1e-4 init, drive the MLPs
    rng = np.random.default_rng(seed)
    scale = lambda t: jnp.asarray(rng.uniform(-1, 1, t.shape), t.dtype)  # noqa: E731
    params = {"table": jax.tree_util.tree_map(scale, params["table"]),
              "mlp": params["mlp"]}
    tm = tngp.NGPModel(tcfg)
    load_ngp_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("grid_impl", ["brick3", "hash"])
def test_ngp_model_f32_through_bridge(grid_impl):
    """NGPModel.apply/density_raw from one JAX init, carried over by the
    bridge (f32, atol 1e-4 on raw outputs of O(1))."""
    jm, params, tm = _models(grid_impl, False)
    pos, d = _positions(400, 7), _positions(400, 8)
    ref = np.asarray(jm.apply(params, jnp.asarray(pos), jnp.asarray(d)))
    with torch.no_grad():
        out = tm(torch.from_numpy(pos), torch.from_numpy(d)).numpy()
        dens = tm.density_raw(torch.from_numpy(pos)).numpy()
    assert out.shape == (400, 4) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(dens, np.asarray(jm.density_raw(
        params, jnp.asarray(pos))), atol=1e-4)
    # the bridge round-trips the tree
    back = ngp_params_to_numpy(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        np.asarray, params))):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_ngp_model_bf16():
    """use_bf16: bf16 MLP weights, bf16 brick interpolation over f32
    tables, bf16 encodings. Outputs are bf16 values; a rounding flip in an
    encoding or an intermediate moves the output by a few bf16 ulps, so
    allow 2^-5 on outputs of O(1) and require most to agree far closer."""
    jm, params, tm = _models("brick3", True, seed=1)
    assert tm.net.density0.dtype == torch.bfloat16
    assert tm.tables[0].dtype == torch.float32
    pos, d = _positions(400, 9), _positions(400, 10)
    ref = np.asarray(jm.apply(params, jnp.asarray(pos), jnp.asarray(d)))
    with torch.no_grad():
        out = tm(torch.from_numpy(pos), torch.from_numpy(d)).numpy()
    err = np.abs(out - ref)
    assert err.max() <= 2.0 ** -5 * max(1.0, np.abs(ref).max())
    assert np.median(err) <= 2.0 ** -8 * max(1.0, np.abs(ref).max())


def test_uint32_hash_wraparound():
    """Brick coords large enough that the prime products wrap uint32."""
    b = np.random.default_rng(11).integers(0, 5000, (300, 3)).astype(np.float32)
    ref = np.asarray(jbg.hash_bricks(jnp.asarray(b))).astype(np.int64)
    out = tbg.hash_bricks(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_checkpoint_reader_bf16(tmp_path):
    """A JAX checkpoint with bf16 MLP weights (fp16=True configs) and f32
    tables, and the optax.adam state beside them, loads bit-exactly through
    the msgpack reader and the bridge."""
    from myc_nerfs_tpu.core.checkpoint import save_checkpoint
    from myc_nerfs_tpu.render import occupancy as jocc
    from myc_nerfs_tpu.train import ngp_trainer as jtr
    from myc_nerfs_tpu_torch.core.checkpoint import restore_checkpoint
    from myc_nerfs_tpu_torch.render import occupancy as tocc
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainState, init_adam

    jm, params, tm = _models("brick3", True, seed=2)
    ocfg = jocc.OccupancyConfig(grid_size=8, n_cascades=2)
    occ = jocc.init_occupancy(ocfg)._replace(
        mean_density=jnp.asarray(0.25), ema_step=jnp.asarray(3, jnp.int32))
    adam, sched = jtr.make_optimizer(jtr.NGPTrainConfig()).init(params)
    adam = adam._replace(count=jnp.asarray(5, jnp.int32),
                         mu=jax.tree_util.tree_map(lambda p: p * 0.5, params),
                         nu=jax.tree_util.tree_map(lambda p: p * p, params))
    sched = sched._replace(count=jnp.asarray(5, jnp.int32))
    path = str(tmp_path / "model.ckpt")
    save_checkpoint(path, jtr.NGPTrainState(params=params, opt_state=(adam, sched),
                                            occ=occ, step=jnp.asarray(7)), step=7)
    fresh = tngp.NGPModel(tm.cfg)
    state = NGPTrainState(params=fresh, opt_state=init_adam(fresh.param_list()),
                          occ=tocc.init_occupancy(
                              tocc.OccupancyConfig(grid_size=8, n_cascades=2)),
                          step=0)
    state, meta = restore_checkpoint(path, state)
    assert meta["step"] == 7 and state.step == 7
    assert state.occ.mean_density.item() == 0.25
    assert state.occ.ema_step.item() == 3
    assert fresh.net.rgb1.dtype == torch.bfloat16
    for a, b in zip(fresh.state_dict().values(), tm.state_dict().values()):
        assert torch.equal(a, b)
    assert int(state.opt_state.count) == 5
    for p, mu, nu in zip(tm.param_list(), state.opt_state.mu, state.opt_state.nu):
        assert mu.dtype == nu.dtype == p.dtype
        assert torch.equal(mu, (p * 0.5).to(p.dtype))
        assert torch.equal(nu, (p * p).to(p.dtype))


def test_density_activation_gradient_matches_jax():
    """exp(min(raw, 30)) forward and the clamped derivative
    exp(clip(raw, +-15)) * g backward, against the JAX custom JVP at raws
    below, inside and above the clamps (rtol 1e-6: one exp each)."""
    raw = np.asarray([-20.0, 0.0, 14.0, 16.0, 40.0], np.float32)
    g = np.asarray([1.0, -2.0, 0.5, 3.0, 1e-3], np.float32)
    jout, jvjp = jax.vjp(jngp.density_activation, jnp.asarray(raw))
    (jgrad,) = jvjp(jnp.asarray(g))
    t = torch.from_numpy(raw).requires_grad_()
    out = tngp.density_activation(t)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-6)
    assert np.isfinite(t.grad.numpy()).all()
