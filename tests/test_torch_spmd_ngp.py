"""NGP data parallelism on the port (parallel/spmd.py, NGPTrainer's mesh
hooks) against the JAX package's GSPMD programs on a CPU mesh of the same
shape, from bridged weights and the JAX side's draws, and against the port
in one process over the whole batch. The ranks run gloo on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.parallel import mesh as jmesh
from myc_nerfs_tpu.parallel import spmd as jspmd
from myc_nerfs_tpu.render import ngp_render as jnr
from myc_nerfs_tpu.train import ngp_trainer as jtr
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.parallel import mesh as tmesh
from myc_nerfs_tpu_torch.parallel import ranks, spmd
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.train import ngp_trainer as ttr

torch.set_num_threads(1)

TIMEOUT = 180.0  # seconds for one launch; a hang fails the test
N_RAYS = 128
# Adam's eps 1e-6 on both sides, not 1e-15: with 1e-15 an element whose
# gradient is rounding noise moves by the whole learning rate, in a
# direction the noise sets (test_torch_ngp_train.py)
TKW = dict(n_rays_per_batch=N_RAYS, target_batch_size=1 << 10, n_grid_uniform=1 << 10,
           n_grid_nonuniform=0, lr=1e-2, eps=1e-6)
GRID = dict(n_levels=4, desired_resolution=64.0)
RKW = dict(aabb_scale=1, n_coarse=32, n_samples=8)


def _jax_rays(seed, n):
    """multichip_ngp_train_step's rays and targets for ``seed``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 1))
    theta = jax.random.uniform(k1, (n,)) * 6.28318
    ro = jnp.stack([0.5 + 1.4 * jnp.cos(theta), 0.5 + 1.4 * jnp.sin(theta),
                    jnp.full((n,), 0.5)], -1)
    rd = 0.5 - ro
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    return [np.asarray(a, np.float32) for a in (ro, rd, jax.random.uniform(k2, (n, 3)))]


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _spec(params, rays, xi, **kw):
    ro, rd, tg = rays
    return dict(rays_o=ro[None], rays_d=rd[None], target=tg[None], xi=xi[None],
                params=params, model_cfg=tngp.NGPModelConfig(grid=tngp.HashGridConfig(**GRID)),
                rcfg=tnr.NGPRenderConfig(**RKW), tcfg=ttr.NGPTrainConfig(**TKW), **kw)


def _close_params(mine, ref, lr):
    """test_torch_ngp_train's criteria: within 1e-6 + 1e-4 |p| on 99% of
    each tensor and everywhere within the learning rate."""
    mine = jax.tree_util.tree_leaves(mine)
    ref = jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        diff = np.abs(a - b)
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(b)) <= 0.01 and diff.max() <= lr


@pytest.mark.parametrize("data", [2, 4])
def test_train_step_matches_jax_on_the_same_mesh(data):
    """One multichip_ngp_train_step at data 2 and 4 against JAX's on a
    CPU mesh of that shape: loss rtol 1e-5, params as _close_params; every
    rank's replicated params bit-equal, and its grid after an update rank
    0's with no collective (each rank's update draws and evaluates the
    same)."""
    jm = jmesh.make_mesh(jax.devices()[:data], data=data, model=1)
    jcfg = jngp.NGPModelConfig(grid=jngp.HashGridConfig(**GRID))
    jt_cfg, jr_cfg = jtr.NGPTrainConfig(**TKW), jnr.NGPRenderConfig(**RKW)
    params0 = _tree(jtr.NGPTrainer(jcfg, jr_cfg, jt_cfg, jax.random.PRNGKey(0)).state.params)
    jstate, jm_out = jspmd.multichip_ngp_train_step(jm, n_rays=N_RAYS, shard_table=False,
                                                    model_cfg=jcfg, rcfg=jr_cfg, tcfg=jt_cfg)
    xi = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (N_RAYS, 1)))
    out = tmesh.spawn(ranks.ngp_block, data, "cpu",
                      _spec(params0, _jax_rays(0, N_RAYS), xi, grid_update=True),
                      timeout=TIMEOUT)
    np.testing.assert_allclose(out[0]["loss"][0], float(jm_out["loss"]), rtol=1e-5)
    assert abs(out[0]["n_samples"][0] - int(jm_out["n_samples"])) <= 0.005 * int(
        jm_out["n_samples"])
    _close_params(out[0]["params"], _tree(jstate.params), TKW["lr"])
    for r in out:
        assert r["checksums"] == out[0]["checksums"] and r["loss"] == out[0]["loss"]
        assert r["grid_checksum"] == out[0]["grid_checksum"]


@pytest.fixture(scope="module")
def block_runs():
    """A 3-step replicated block on 4 x 1 ranks and on one process, same
    weights and draws (the JAX block's grid, rays from the JAX keys)."""
    S, B = 3, 256
    cfg = spmd.block_model_cfg("replicated")
    jcfg = jngp.NGPModelConfig(grid=jngp.HashGridConfig(n_levels=4, desired_resolution=64.0))
    params0 = _tree(jtr.NGPTrainer(jcfg, jnr.NGPRenderConfig(**RKW),
                                   jtr.NGPTrainConfig(**TKW), jax.random.PRNGKey(0)).state.params)
    ro, rd, tg = _jax_rays(0, S * B)
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    xi = np.stack([np.asarray(jax.random.uniform(k, (B, 1))) for k in keys])
    spec = dict(rays_o=ro.reshape(S, B, 3), rays_d=rd.reshape(S, B, 3),
                target=tg.reshape(S, B, 3), xi=xi, params=params0, model_cfg=cfg,
                tcfg=ttr.NGPTrainConfig(**{**TKW, "n_rays_per_batch": B}),
                render=(tnr.NGPRenderConfig(**RKW), ro[:64], rd[:64]), adapt=True)
    dp = tmesh.spawn(ranks.ngp_block, 4, "cpu", spec, timeout=TIMEOUT)
    one = ranks.ngp_block(tmesh.single_mesh("cpu"), spec)
    return dp, one


def test_block_matches_one_process(block_runs):
    """Per-step losses rtol 1e-5 (the shards' mean gradients sum in another
    order), params as _close_params, samples equal; the replicated params
    bit-equal on every rank after every step."""
    dp, one = block_runs
    np.testing.assert_allclose(dp[0]["loss"], one["loss"], rtol=1e-5)
    assert dp[0]["n_samples"] == one["n_samples"]
    _close_params(dp[0]["params"], one["params"], TKW["lr"])
    for r in dp:
        assert r["checksums"] == dp[0]["checksums"]


def test_batch_adaptation_picks_one_rung(block_runs):
    """The measured samples are the global batch's on every rank, so the
    adaptation picks the one-process rung on each."""
    dp, one = block_runs
    assert {r["n_rays_per_batch"] for r in dp} == {one["n_rays_per_batch"]}
    assert one["n_rays_per_batch"] != 256


def test_dp_render_matches_one_process(block_runs):
    """The DP render of the trained block against one process's render of
    its own trained block: rgb and depth within 1e-5 (the two states differ
    by the block's rounding), the sample count equal; every rank holds the
    whole batch, the same on each."""
    dp, one = block_runs
    for r in dp:
        np.testing.assert_array_equal(r["render"]["rgb"], dp[0]["render"]["rgb"])
        assert r["render"]["rgb"].shape == (64, 3)
    np.testing.assert_allclose(dp[0]["render"]["rgb"], one["render"]["rgb"], atol=1e-5)
    np.testing.assert_allclose(dp[0]["render"]["depth"], one["render"]["depth"], atol=1e-5)
    assert dp[0]["render"]["n_samples"] == one["render"]["n_samples"]


def test_dp_render_of_one_state_is_exact():
    """multichip_ngp_render on 4 ranks against render_rays_ngp in one
    process, one model and grid (the JAX TestDPRender's setup): rgb and
    depth within 1e-6 (per-ray programs on smaller batches)."""
    from myc_nerfs_tpu_torch.core import bridge
    from myc_nerfs_tpu_torch.render import occupancy as tocc

    jcfg = jngp.NGPModelConfig(grid=jngp.HashGridConfig(n_levels=4, desired_resolution=64.0))
    params = _tree(jngp.NGPModel(jcfg).init(jax.random.PRNGKey(3)))
    ro, rd, _ = _jax_rays(3, 64)
    spec = dict(rays_o=ro[None, :8], rays_d=rd[None, :8], target=np.zeros((1, 8, 3), np.float32),
                xi=np.zeros((1, 8, 1), np.float32), params=params,
                model_cfg=tngp.NGPModelConfig(grid=tngp.HashGridConfig(**GRID)),
                tcfg=ttr.NGPTrainConfig(**{**TKW, "lr": 0.0}),
                render=(tnr.NGPRenderConfig(**RKW), ro, rd))
    dp = tmesh.spawn(ranks.ngp_block, 4, "cpu", spec, timeout=TIMEOUT)
    model = tngp.NGPModel(tngp.NGPModelConfig(grid=tngp.HashGridConfig(**GRID)), device="cpu")
    bridge.load_params(model, params)
    occ_cfg = tocc.OccupancyConfig()
    st = spmd.occupancy_on(tocc.init_occupancy(occ_cfg))
    with torch.no_grad():
        ref = tnr.render_rays_ngp(occ_cfg, tnr.NGPRenderConfig(**RKW), model, st,
                                  torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
                                  torch.ones(3))
    np.testing.assert_allclose(dp[0]["render"]["rgb"], ref.rgb.numpy(), atol=1e-6)
    np.testing.assert_allclose(dp[0]["render"]["depth"], ref.depth.numpy(), atol=1e-6)
