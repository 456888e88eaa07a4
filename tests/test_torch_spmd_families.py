"""Data parallelism beyond NGP on the port (parallel/spmd.py): TensoRF's
ray-axis DP block and render, and BARF/GARF's image-axis DP block, against
the JAX package's GSPMD programs on a 4-device CPU mesh from bridged
weights and the JAX side's draws, and against the port in one process;
then the entry points, entry.dryrun_multichip and cli/multichip, at tiny
widths on the CPU. The ranks run gloo on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.data import synthetic as jsyn
from myc_nerfs_tpu.models import tensorf as jtf
from myc_nerfs_tpu.parallel import mesh as jmesh
from myc_nerfs_tpu.parallel import spmd as jspmd
from myc_nerfs_tpu.train import nerf_trainer as jnt
from myc_nerfs_tpu.train import tensorf_trainer as jtt
from myc_nerfs_tpu_torch.core import bridge
from myc_nerfs_tpu_torch.parallel import mesh as tmesh
from myc_nerfs_tpu_torch.parallel import ranks, spmd
from myc_nerfs_tpu_torch.train import nerf_trainer as tnt

torch.set_num_threads(1)

TIMEOUT = 180.0  # seconds for one launch; a hang fails the test

def _jmesh():
    return jmesh.make_mesh(jax.devices()[:4], data=4, model=1)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- TensoRF -----------------------------------------------------------------


def _jax_tensorf_inputs(n_rays, n_steps, seed=0):
    """multichip_tensorf_train_block's configs (the sample budgets off and
    exact factor gathers, as every TensoRF parity test), initial params,
    rays, rgbs and each step's jitter, from the JAX keys."""
    mcfg_t, tcfg_t, aabb = spmd.tensorf_block_configs(n_rays, n_steps)
    mcfg = jtf.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=8,
                             featureC=16, near_far=(1.5, 4.5), distance_scale=25.0,
                             density_shift=-5.0, shading_mode="MLP_Fea",
                             density_sample_budget=0, app_sample_budget=0,
                             density_batch_budget=0, factor_gather_bf16=False)
    tcfg = jtt.TensoRFTrainConfig(n_iters=n_steps, batch_size=n_rays, n_voxel_init=8 ** 3,
                                  n_voxel_final=8 ** 3, upsamp_list=(),
                                  update_alphamask_list=(), n_samples_cap=16)
    params = _tree(jtt.TensoRFTrainer(mcfg, tcfg, aabb, jax.random.PRNGKey(seed)).params)
    H = W = max(8, int(np.ceil(np.sqrt(n_steps * n_rays / 4.0))))
    f = 1.2 * W
    intr = jnp.broadcast_to(jnp.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]]),
                            (4, 3, 3))
    store = jtt.build_ray_store(jsyn.orbit_poses(4), intr, H, W)
    ids = jax.random.permutation(jax.random.PRNGKey(seed + 1), store.shape[0])
    rays = np.asarray(store[ids[:n_steps * n_rays]]).reshape(n_steps, n_rays, 6)
    rgbs = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed + 2), (n_steps, n_rays, 3)))
    jitter = np.stack([np.asarray(jax.random.uniform(k, (n_rays, 1)))
                       for k in jax.random.split(jax.random.PRNGKey(7), n_steps)])
    return mcfg, tcfg, (mcfg_t, tcfg_t, aabb), params, rays, rgbs, jitter


@pytest.fixture(scope="module")
def tensorf_runs():
    """One step (test_multichip's protocol: a second Adam step amplifies
    reduction-order noise) of JAX's DP block on 4 x 1, the port's on 4 x 1
    ranks and in one process; and a 2-step port run on 4 x 1 ranks with a
    render of its params."""
    mcfg, tcfg, (mcfg_t, tcfg_t, aabb), params, rays, rgbs, jitter = _jax_tensorf_inputs(64, 1)
    jmet, jparams = jspmd.multichip_tensorf_train_block(_jmesh(), n_rays=64, n_steps=1,
                                                        mcfg=mcfg, tcfg=tcfg)
    spec = dict(rays=rays, rgbs=rgbs, draws=jitter, mcfg=mcfg_t, tcfg=tcfg_t, aabb=aabb,
                params=params)
    dp = tmesh.spawn(ranks.tensorf_block, 4, "cpu", spec, timeout=TIMEOUT)
    one = ranks.tensorf_block(tmesh.single_mesh("cpu"), spec)
    two = _jax_tensorf_inputs(64, 2)
    spec2 = dict(rays=two[4], rgbs=two[5], draws=two[6], mcfg=two[2][0], tcfg=two[2][1],
                 aabb=two[2][2], params=two[3], render=two[4][0])
    dp2 = tmesh.spawn(ranks.tensorf_block, 4, "cpu", spec2, timeout=TIMEOUT)
    return jmet, _tree(jparams), dp, one, dp2, spec2


def _close(a_tree, b_tree, rtol, atol):
    a, b = jax.tree_util.tree_leaves(a_tree), jax.tree_util.tree_leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol, atol=atol)


def test_tensorf_dp_block_matches_jax_and_one_process(tensorf_runs):
    """mse rtol 1e-5; params rtol 2e-3, atol 2e-5 (test_multichip.py's
    tolerances for DP against replicated) against JAX's DP block and the
    port's one process; the params bit-equal on every rank."""
    jmet, jparams, dp, one, _, _ = tensorf_runs
    np.testing.assert_allclose(dp[0]["mse"][-1], float(jmet["mse"]), rtol=1e-5)
    np.testing.assert_allclose(dp[0]["mse"], one["mse"], rtol=1e-5)
    _close(dp[0]["params"], jparams, 2e-3, 2e-5)
    _close(dp[0]["params"], one["params"], 2e-3, 2e-5)
    assert all(r["checksums"] == dp[0]["checksums"] for r in dp)


def test_tensorf_dp_two_steps_and_render(tensorf_runs):
    """Two steps stay finite with the replicas bit-equal after each; the DP
    render of the trained params equals one process's render of them
    (rgb and depth within 1e-6) on every rank."""
    from myc_nerfs_tpu_torch.train import tensorf_trainer as ttt

    _, _, _, _, dp2, spec2 = tensorf_runs
    assert np.isfinite(dp2[0]["mse"]).all()
    assert all(r["checksums"] == dp2[0]["checksums"] for r in dp2)
    tr = ttt.TensoRFTrainer(spec2["mcfg"], spec2["tcfg"], spec2["aabb"],
                            torch.Generator().manual_seed(0), device="cpu")
    tr.params = bridge.load_tensorf_params(tr.params, dp2[0]["params"])
    rgb, depth = tr.render_rays(torch.from_numpy(np.array(spec2["render"])))
    for r in dp2:
        np.testing.assert_allclose(r["render"]["rgb"], rgb.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["render"]["depth"], depth.numpy(), atol=1e-6)


def test_tensorf_train_loop_slices_the_samplers_batches(tensorf_runs):
    """TensoRFTrainer(mesh=...).train: the permutation sampler draws the
    global ids and the jitter is the global batch's, each rank slicing its
    rows; 3 steps on 4 x 1 ranks against one process: the last mse rtol
    1e-5, params rtol 2e-3, atol 2e-5, the same on every rank."""
    _, _, _, _, _, spec2 = tensorf_runs
    spec = dict(spec2, rays=spec2["rays"].reshape(-1, 6), rgbs=spec2["rgbs"].reshape(-1, 3),
                draws=np.random.default_rng(3).uniform(0, 1, (3, 64, 1)).astype(np.float32),
                n_iters=3)
    dp = tmesh.spawn(ranks.tensorf_train, 4, "cpu", spec, timeout=TIMEOUT)
    one = ranks.tensorf_train(tmesh.single_mesh("cpu"), spec)
    np.testing.assert_allclose(dp[0]["mse"], one["mse"], rtol=1e-5)
    _close(dp[0]["params"], one["params"], 2e-3, 2e-5)
    for r in dp[1:]:
        _close(r["params"], dp[0]["params"], 0, 0)


# -- BARF / GARF ---------------------------------------------------------------


def _garf_inputs(n_images=8, size=10, n_steps=1):
    """multichip_nerf_train_block's run from the JAX side: its config, scene,
    initial weights and pose noise, and each step's draws from the block's
    keys (split into ray indices, depth jitter, noise as _make_step_raw)."""
    jcfg = jnt.NeRFTrainConfig(model="garf", refine_pose=True, camera_noise=0.05,
                               start_pose_correct_iter=0, rand_rays=n_images * 16,
                               sample_intvs=8, max_iter=64, mlp_tile=False)
    tcfg = tnt.NeRFTrainConfig(**{k: getattr(jcfg, k)
                                  for k in tnt.NeRFTrainConfig.__dataclass_fields__})
    scene = jsyn.make_scene(n_views=n_images, H=size, W=size)
    _, state = jnt.init_state(jcfg, jax.random.PRNGKey(0), n_images)
    R = jcfg.rand_rays // n_images
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(7), n_steps):
        k_idx, k_depth, _ = jax.random.split(key, 3)
        draws.append({"ray_idx": np.asarray(jax.random.randint(k_idx, (R,), 0, size * size)),
                      "depth": np.asarray(jax.random.uniform(
                          k_depth, (n_images, R, jcfg.sample_intvs, 1))),
                      "noise": None, "noise_fine": None})
    return dict(cfg=tcfg, images=np.asarray(scene.images), poses=np.asarray(scene.poses),
                intr=np.asarray(scene.intr), draws=draws, params=_tree(state.params),
                pose_noise=np.array(state.pose_noise))


def test_garf_image_dp_matches_jax_and_one_process():
    """One GARF step with pose refinement on 8 images over 4 ranks against
    JAX's image-axis DP block on 4 devices: se3_refine rtol 2e-3, atol 2e-6
    (test_multichip.py:359-363); the loss rtol 1e-4: at GARF's 8 x 256
    width the gaussians scale each f32 rounding, and the two packages' loss
    differs by 2.7e-5 in one process as on the mesh (JAX's loss is the same
    on 1, 4 and 8 devices, the port's on 1 and 4 ranks). Against the port in
    one process: loss rtol 1e-5, se3_refine as above; the MLP bit-equal on
    every rank, two steps finite."""
    jst, jmet = jspmd.multichip_nerf_train_block(_jmesh(), n_images=8, size=10, n_steps=1)
    spec = _garf_inputs()
    dp = tmesh.spawn(ranks.nerf_block, 4, "cpu", spec, timeout=TIMEOUT)
    one = ranks.nerf_block(tmesh.single_mesh("cpu"), spec)
    np.testing.assert_allclose(dp[0]["loss"][-1], float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(dp[0]["se3_refine"], np.asarray(jst.se3_refine),
                               rtol=2e-3, atol=2e-6)
    np.testing.assert_allclose(dp[0]["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(dp[0]["se3_refine"], one["se3_refine"], rtol=2e-3, atol=2e-6)
    assert np.abs(dp[0]["se3_refine"]).max() > 0
    for r in dp:
        assert [c["replicated"] for c in r["checksums"]] == [
            c["replicated"] for c in dp[0]["checksums"]]
        np.testing.assert_array_equal(r["se3_refine"], dp[0]["se3_refine"])
    spec2 = _garf_inputs(n_steps=2)
    dp2 = tmesh.spawn(ranks.nerf_block, 4, "cpu", spec2, timeout=TIMEOUT)
    assert np.isfinite(dp2[0]["loss"]).all() and np.isfinite(dp2[0]["se3_refine"]).all()


def test_slice_draws_takes_this_ranks_images():
    """StepDraws' per-image rows are sliced; the shared ray indices are not."""
    mesh = tmesh.Mesh(data=4, model=1, rank=2, device=torch.device("cpu"), backend="gloo")
    d = tnt.StepDraws(ray_idx=torch.arange(5), depth=torch.arange(8.0).reshape(8, 1, 1, 1),
                      noise=torch.arange(8.0).reshape(8, 1, 1))
    s = spmd.slice_draws(mesh, d)
    assert torch.equal(s.ray_idx, d.ray_idx) and s.noise_fine is None
    assert s.depth.reshape(-1).tolist() == [4.0, 5.0] and s.noise.reshape(-1).tolist() == [4, 5]


# -- the entry points ------------------------------------------------------------


def test_dryrun_multichip_on_cpu(capsys):
    """entry.dryrun_multichip(4, "cpu"): a 2 x 2 GroupTP train block of 4
    steps, finite, one line of the JAX dry run's shape."""
    from myc_nerfs_tpu_torch.entry import dryrun_multichip

    loss = dryrun_multichip(4, "cpu")
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): mesh {'data': 2, 'model': 2}, 4-step train block, loss" in out
    assert "backend gloo" in out


def test_entry_points_need_a_card_unless_told():
    from myc_nerfs_tpu_torch.cli import multichip
    from myc_nerfs_tpu_torch.entry import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="is_available"):
        dryrun_multichip(4)
    with pytest.raises(SystemExit, match="is_available"):
        multichip.main(["--ranks", "4"])


def test_cli_multichip_small_on_cpu(capsys):
    """cli/multichip at tiny widths on 4 CPU ranks: one JSON line per leg
    (ngp and render on 2 x 2, garf and tensorf on 4 x 1), each finite and
    naming its mesh and backend."""
    from myc_nerfs_tpu_torch.cli import multichip

    multichip.main(["--ranks", "4", "--small", "--device", "cpu", "--steps", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["event"] for x in lines] == ["multichip_ngp", "multichip_render",
                                           "multichip_garf", "multichip_tensorf"]
    assert lines[0]["mesh"] == {"data": 2, "model": 2}
    assert lines[2]["mesh"] == lines[3]["mesh"] == {"data": 4, "model": 1}
    for x in lines:
        assert x["backend"] == "gloo" and x.get("finite", x.get("rgb_finite"))
