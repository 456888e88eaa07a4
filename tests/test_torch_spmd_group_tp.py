"""Group tensor parallelism on the port (parallel/spmd.GroupTPModel): the
hashed brick3 group tables split over "model", against the one-process
brick3 model and the JAX package's GroupTPModel on a CPU mesh of the same
shape; its train block against the replicated one and JAX's; its render;
and core/bridge.py's conversions of the JAX package's stacked, padded
tables. The ranks run gloo on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.parallel import mesh as jmesh
from myc_nerfs_tpu.parallel import spmd as jspmd
from myc_nerfs_tpu_torch.core import bridge
from myc_nerfs_tpu_torch.core import checkpoint as tck
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.parallel import mesh as tmesh
from myc_nerfs_tpu_torch.parallel import ranks, spmd
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.train import ngp_trainer as ttr

torch.set_num_threads(1)

TIMEOUT = 180.0  # seconds for one launch; a hang fails the test
# 1 dense + 6 hashed levels -> 2 triple groups (the JAX tests' grid; the
# train block's)
GRID = dict(n_levels=7, log2_hashmap_size=14, desired_resolution=512.0)
# 1 dense + 11 hashed levels in 4 groups, the first narrow (2 levels), as
# L16F2's hashed levels group; model 2 and 4
WIDE = dict(n_levels=12, log2_hashmap_size=14, desired_resolution=512.0)
RKW = dict(aabb_scale=1, n_coarse=32, n_samples=8)


def _cfgs(grid):
    return (jngp.NGPModelConfig(grid=jngp.HashGridConfig(**grid), grid_impl="brick3"),
            tngp.NGPModelConfig(grid=tngp.HashGridConfig(**grid), grid_impl="brick3"))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _fake_mesh(model, m):
    """A mesh without process groups: enough to build a rank's model."""
    return tmesh.Mesh(data=1, model=model, rank=m, device=torch.device("cpu"), backend="gloo")


@pytest.fixture(scope="module")
def jax_encode():
    """JAX's GroupTPModel on a 1 x 2 CPU mesh (the WIDE grid) applied to
    64 points, and the gradient of the sum of its outputs."""
    jcfg, _ = _cfgs(WIDE)
    jm = jmesh.make_mesh(jax.devices()[:2], data=1, model=2)
    jtp = jspmd.GroupTPModel(jcfg, jm)
    p_tp = jtp.init(jax.random.PRNGKey(4))
    pos = jax.random.uniform(jax.random.PRNGKey(5), (64, 3))
    dirs = jax.random.uniform(jax.random.PRNGKey(6), (64, 3))
    with jm:
        j_out = np.asarray(jtp.apply(p_tp, pos, dirs))
        j_g = jax.grad(lambda p: jtp.apply(p, pos, dirs).sum())(p_tp)
    return _tree(p_tp), np.array(pos), np.array(dirs), j_out, _tree(j_g)


@pytest.mark.parametrize("model", [2, 4])
def test_encode_matches_brick3_and_jax(jax_encode, model):
    """A GroupTPModel on 1 x model ranks (model 2 and 4 over 4 groups, the
    first narrow) applied to 64 points and the gradient of the sum of its
    outputs: equal bit for bit to the one-process brick3 model (each
    level's encode runs the same arithmetic on the same rows), and within
    1e-5 of JAX's GroupTPModel at model 2, outputs and every table's
    gradient (JAX's padded columns get zero gradient; its member scales are
    traced f32, the port's Python doubles, as in JAX's own test against
    brick3)."""
    p_tp, pos, dirs, j_out, j_g = jax_encode
    _, tcfg = _cfgs(WIDE)
    spec = dict(model_cfg=tcfg, params=p_tp, pos=pos, dirs=dirs)
    out = tmesh.spawn(ranks.group_tp_encode, model, "cpu", spec, model=model, timeout=TIMEOUT)
    # the one-process brick3 model holding the same tables
    plain = tngp.NGPModel(tcfg, device="cpu")
    bridge.load_params(plain, bridge.group_tp_to_brick3(p_tp, plain))
    with torch.enable_grad():
        ref = plain(torch.from_numpy(pos), torch.from_numpy(dirs))
        ref_g = torch.autograd.grad(ref.sum(), plain.param_list())
    ref_g = [g.numpy() for g in ref_g]
    nd = len(out[0]["dense"])
    widths = [t.shape[1] for t in ref_g[nd:len(plain.tables)]]
    j_hashed = bridge.group_tp_unstack(j_g["table"]["hashed"], widths)
    for r in out:
        np.testing.assert_array_equal(r["out"], ref.detach().numpy())
        np.testing.assert_allclose(r["out"], j_out, atol=1e-5)
        for i, g in enumerate(r["dense"]):
            np.testing.assert_array_equal(g, ref_g[i])
            np.testing.assert_allclose(g, np.asarray(j_g["table"]["dense"][i]), atol=1e-5)
        for gi, g in r["hashed"].items():
            np.testing.assert_array_equal(g, ref_g[gi])
            np.testing.assert_allclose(g, j_hashed[gi - nd], atol=1e-5)
        for a, b in zip(r["mlp"], ref_g[len(plain.tables):]):
            np.testing.assert_array_equal(a, b)
    stacked = j_g["table"]["hashed"]
    for gi, w in enumerate(widths):
        assert not stacked[gi][:, w:].any()  # JAX's pad columns
    # every hashed group is held by exactly one model-rank
    held = sorted(gi for r in out for gi in r["hashed"])
    assert held == list(range(nd, len(plain.tables)))


def _block_spec(table_mode, params, S=3, B=256):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    theta = jax.random.uniform(k1, (S * B,)) * 6.28318
    ro = jnp.stack([0.5 + 1.4 * jnp.cos(theta), 0.5 + 1.4 * jnp.sin(theta),
                    jnp.full((S * B,), 0.5)], -1)
    rd = 0.5 - ro
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    tg = jax.random.uniform(k2, (S * B, 3))
    xi = np.stack([np.asarray(jax.random.uniform(k, (B, 1)))
                   for k in jax.random.split(jax.random.PRNGKey(7), S)])
    f = lambda a: np.asarray(a, np.float32).reshape(S, B, 3)  # noqa: E731
    return dict(rays_o=f(ro), rays_d=f(rd), target=f(tg), xi=xi, params=params,
                model_cfg=_cfgs(GRID)[1], table_mode=table_mode,
                render=(tnr.NGPRenderConfig(**RKW), f(ro)[0, :64], f(rd)[0, :64]))


@pytest.fixture(scope="module")
def group_runs():
    """JAX's 3-step 'groups' block on a 2 x 2 CPU mesh, and the port's on
    2 x 2 ranks ('groups') and 4 x 1 ranks ('replicated') from the same
    weights (the JAX block's own init) and draws; the JAX defaults (lr 0.1,
    Adam eps 1e-15)."""
    jcfg, tcfg = _cfgs(GRID)
    jm = jmesh.make_mesh(jax.devices()[:4], data=2, model=2)
    p_tp = _tree(jspmd.GroupTPModel(jcfg, jm).init(jax.random.PRNGKey(0)))
    jstate, jmet = jspmd.multichip_ngp_train_block(jm, n_rays=256, n_steps=3,
                                                   table_mode="groups", seed=0)
    tp = tmesh.spawn(ranks.ngp_block, 4, "cpu", _block_spec("groups", p_tp), model=2,
                     timeout=TIMEOUT)
    brick3 = bridge.group_tp_to_brick3(p_tp, tngp.NGPModel(tcfg, device="cpu"))
    rep = tmesh.spawn(ranks.ngp_block, 4, "cpu", _block_spec("replicated", brick3),
                      timeout=TIMEOUT)
    return jstate, jmet, tp, rep


def _close_params(mine, ref, lr):
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        diff = np.abs(a - b)
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(b)) <= 0.01 and diff.max() <= lr


def test_group_block_matches_replicated(group_runs):
    """GroupTP on 2 x 2 against the replicated block on 4 x 1: per-step
    losses rtol 1e-5, params within 1e-6 + 1e-4 |p| on 99% of each tensor
    and within the learning rate everywhere (Adam's eps 1e-15 turns a
    gradient's rounding into a step); the dense tables and MLPs bit-equal
    on every rank, each local table on the ranks of its data group."""
    _, _, tp, rep = group_runs
    np.testing.assert_allclose(tp[0]["loss"], rep[0]["loss"], rtol=1e-5)
    _close_params(tp[0]["params"], rep[0]["params"], 0.1)
    for r in tp:
        peer = tp[r["model_index"]]  # the data-index-0 rank of its data group
        for s, c in enumerate(r["checksums"]):
            assert c["replicated"] == tp[0]["checksums"][s]["replicated"]
            assert c["local"] == peer["checksums"][s]["local"]
    assert tp[0]["checksums"][-1]["local"] != tp[1]["checksums"][-1]["local"]


def test_group_block_matches_jax(group_runs):
    """The port's 2 x 2 GroupTP block against JAX's on a 2 x 2 CPU mesh:
    the last step's loss rtol 1e-5, the tables and MLPs as
    test_group_block_matches_replicated (JAX's stacked tables unpadded)."""
    jstate, jmet, tp, _ = group_runs
    np.testing.assert_allclose(tp[0]["loss"][-1], float(jmet["loss"]), rtol=1e-5)
    jp = _tree(jstate.params)
    _close_params(tp[0]["params"], bridge.group_tp_to_brick3(
        jp, tngp.NGPModel(_cfgs(GRID)[1], device="cpu")), 0.1)


def test_group_render_matches_one_process(group_runs):
    """The DP x TP render (rays over "data", tables over "model") of the
    trained block against one process's render of the same gathered state:
    rgb and depth within 1e-6 (per-ray programs on smaller batches); the
    same on every rank."""
    from myc_nerfs_tpu_torch.render import occupancy as tocc

    _, _, tp, _ = group_runs
    spec = _block_spec("groups", None)
    rcfg, ro, rd = spec["render"]
    model = tngp.NGPModel(_cfgs(GRID)[1], device="cpu")
    bridge.load_params(model, tp[0]["params"])
    grid = bridge.occupancy_from_numpy(tp[0]["occ"])
    with torch.no_grad():
        ref = tnr.render_rays_ngp(tocc.OccupancyConfig(), rcfg, model, grid,
                                  torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
                                  torch.ones(3))
    for r in tp:
        np.testing.assert_allclose(r["render"]["rgb"], ref.rgb.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["render"]["depth"], ref.depth.numpy(), atol=1e-6)


def test_bridge_stacked_tables_round_trip():
    """JAX's stacked, zero-padded [G, rows, Wmax] hashed tables go to each
    model-rank's unpadded list and back bit for bit (model 2 and 4 over 4
    groups, the first narrow)."""
    jcfg, tcfg = _cfgs(WIDE)
    jm = jmesh.make_mesh(jax.devices()[:4], data=1, model=4)
    p_tp = _tree(jspmd.GroupTPModel(jcfg, jm).init(jax.random.PRNGKey(2)))
    stacked = p_tp["table"]["hashed"]
    assert stacked.shape[0] == 4
    for model in (2, 4):
        held = {}
        for m in range(model):
            tp = spmd.GroupTPModel(tcfg, _fake_mesh(model, m), device="cpu")
            bridge.load_group_tp_params(tp, p_tp)
            nd = len(tp.dense_groups)
            for gi, t in zip(tp.local_groups, tp.tables[nd:]):
                held[gi] = t.detach()
            for a, b in zip(tp.tables[:nd], p_tp["table"]["dense"]):
                np.testing.assert_array_equal(a.detach().numpy(), b)
        back = bridge.group_tp_stack([held[g] for g in sorted(held)])
        np.testing.assert_array_equal(back, stacked)


def test_checkpoint_of_gathered_state_restores_one_process(group_runs, tmp_path):
    """The 2 x 2 run's tables gathered into the one-process brick3 layout,
    written as a checkpoint and restored into a single-process NGPTrainer:
    every parameter bit for bit."""
    _, _, tp, _ = group_runs
    tcfg = _cfgs(GRID)[1]
    make = lambda: ttr.NGPTrainer(tcfg, tnr.NGPRenderConfig(**RKW),  # noqa: E731
                                  ttr.NGPTrainConfig(), torch.Generator().manual_seed(9),
                                  device="cpu")
    src = make()
    bridge.load_params(src.model, tp[0]["params"])
    path = str(tmp_path / "tp.ckpt")
    tck.save_checkpoint(path, src.state, step=3)
    dst = make()
    dst.state, meta = tck.restore_checkpoint(path, dst.state)
    assert meta["step"] == 3
    leaves = bridge.param_leaves(dst.model, tp[0]["params"])
    assert len(leaves) == len(dst.state.params.param_list())
    for a, b in zip(dst.state.params.param_list(), leaves):
        np.testing.assert_array_equal(a.detach().numpy(), b)
