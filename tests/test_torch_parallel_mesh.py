"""The port's mesh layer (myc_nerfs_tpu_torch/parallel/mesh.py) against the
JAX package's on a CPU mesh of the same shape: the rank layout, the batch
shards, a data-sharded mean-loss gradient (test_multichip.py's
test_psum_loss_matches_single_device), the gathers, and the launcher's
failure paths. The ranks run gloo on the CPU in spawned processes, each
launch with its own time limit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.parallel import mesh as jmesh
from myc_nerfs_tpu_torch.parallel import mesh as tmesh
from myc_nerfs_tpu_torch.parallel import ranks, spmd

torch.set_num_threads(1)

TIMEOUT = 120.0  # seconds for one launch; a hang fails the test
BATCH = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
W = np.ones(4, np.float32)


@pytest.fixture(scope="module", params=[(2, 1), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def probe(request):
    data, model = request.param
    out = tmesh.spawn(ranks.mesh_probe, data * model, "cpu", BATCH, W, model=model,
                      timeout=TIMEOUT)
    return data, model, out


def _jax_mesh(data, model):
    return jmesh.make_mesh(jax.devices()[:data * model], data=data, model=model)


def test_rank_layout_matches_jax_mesh(probe):
    """rank = d * model + m, the JAX mesh's device at [d, m]; the shape is
    the JAX mesh's."""
    data, model, out = probe
    jm = _jax_mesh(data, model)
    assert dict(jm.shape) == out[0]["shape"] == {"data": data, "model": model}
    for r, res in enumerate(out):
        d, m = res["data_index"], res["model_index"]
        assert res["rank"] == r and jm.devices[d, m].id == jax.devices()[r].id
        assert res["backend"] == "gloo"


def test_shard_batch_matches_jax_shards(probe):
    """Each rank's slice is the rows the JAX data sharding puts on its
    device (ranks of one model group hold the same rows)."""
    data, model, out = probe
    jm = _jax_mesh(data, model)
    xs = jmesh.shard_batch(jm, jnp.asarray(BATCH))
    by_device = {s.device.id: np.asarray(s.data) for s in xs.addressable_shards}
    for r, res in enumerate(out):
        np.testing.assert_array_equal(res["shard"], by_device[jax.devices()[r].id])


def test_psum_loss_matches_single_device(probe):
    """The mean of the shards' mean-loss gradients equals the JAX sharded
    gradient and the unsharded one (rtol 1e-6), on every rank bit for bit."""
    data, model, out = probe
    jm = _jax_mesh(data, model)

    def loss(w, x):
        return jnp.mean((x @ w) ** 2)

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(W), jnp.asarray(BATCH)))
    g_sharded = np.asarray(jax.jit(jax.grad(loss))(
        jax.device_put(jnp.asarray(W), jmesh.replicated(jm)),
        jmesh.shard_batch(jm, jnp.asarray(BATCH))))
    for res in out:
        np.testing.assert_allclose(res["grad"], g_ref, rtol=1e-6)
        np.testing.assert_allclose(res["grad"], g_sharded, rtol=1e-6)
        np.testing.assert_array_equal(res["grad"], out[0]["grad"])


def test_gather_rows_restores_order(probe):
    """gather_rows over "data" gives the batch back in order; over "world"
    the ranks in rank order."""
    data, model, out = probe
    for res in out:
        np.testing.assert_array_equal(res["gathered"], BATCH)
        np.testing.assert_array_equal(res["gathered_world"], np.arange(data * model))


def test_single_mesh_is_the_identity():
    """One process: shard_batch keeps everything and every collective
    returns its input; collectives keep each tensor's dtype."""
    m = tmesh.single_mesh("cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert m.shape == {"data": 1, "model": 1} and m.data_index == m.model_index == 0
    assert tmesh.shard_batch(m, x) is x
    b = x.to(torch.bfloat16)
    (r,) = tmesh.all_reduce_mean(m, [b])
    assert r is b and tmesh.gather_rows(m, x) is x
    assert tmesh.make_mesh().size == 1


def test_shard_batch_requires_equal_shards():
    mesh = tmesh.Mesh(data=4, model=1, rank=1, device=torch.device("cpu"), backend="gloo")
    assert tmesh.shard_slice(mesh, 8) == slice(2, 4)
    with pytest.raises(ValueError, match="split evenly"):
        tmesh.shard_batch(mesh, torch.zeros(10, 3))


def test_choose_backend():
    """gloo on the CPU; without a card, "cuda" exits with a message."""
    backend, devices, line = tmesh.choose_backend("cpu", 4)
    assert backend == "gloo" and devices == [torch.device("cpu")] * 4 and "gloo" in line
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="is_available"):
            tmesh.choose_backend("cuda", 4)


def test_not_ported_table_modes_raise():
    """LevelTPModel and table modes 'rows' / 'levels' raise with ROADMAP's
    reason."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmd.LevelTPModel()
    for mode in ("rows", "levels"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            spmd.place_ngp_state(tmesh.single_mesh(), None, table_mode=mode)


def test_spawn_raises_a_failing_ranks_traceback():
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        tmesh.spawn(ranks.fail_on, 2, "cpu", 1, timeout=TIMEOUT)


def test_spawn_gives_up_at_its_time_limit():
    with pytest.raises(TimeoutError):
        tmesh.spawn(ranks.sleep_on, 2, "cpu", 0, 600.0, timeout=15.0)
