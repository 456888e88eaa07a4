"""cli/pose_chain against scripts/pose_chain_scale.py: the field frame
(_field_c2w), the Procrustes pose error, the sim3 transfer of the GT val
poses into the refined frame (compare_pose, then parse_raw_camera_barf),
and CPU smokes of the whole chain (every leg, test-time optimisation,
the transforms written to --out_dir, the gate and --skip), its refusal
to run without a card, and the GARF step against the JAX step across the
correction gate's opening (F5)."""
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.cli import pose_chain as tpc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    """scripts/pose_chain_scale.py as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "pose_chain_scale", os.path.join(REPO, "scripts", "pose_chain_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _poses(seed, n):
    from myc_nerfs_tpu.geom import lie as jlie

    rng = np.random.default_rng(seed)
    return np.asarray(jlie.se3_to_SE3(jnp.asarray(rng.standard_normal((n, 6)) * 0.6,
                                                  jnp.float32)))


def test_field_frame_and_pose_error_match_script(script):
    """field_c2w (rtol 1e-6, atol 1e-6) and pose_error (rtol 1e-4, atol
    1e-6: an SVD apart) against the script's on the same poses."""
    gt = _poses(0, 8)
    noisy = np.asarray(script.pose_lib.compose_pair(
        script.lie.se3_to_SE3(jnp.asarray(np.random.default_rng(1).standard_normal((8, 6))
                                          * 0.05, jnp.float32)), jnp.asarray(gt)))
    assert tpc.SCALE == script.SCALE and tpc.OFF == script.OFF
    for p in gt:
        np.testing.assert_allclose(tpc.field_c2w(torch.from_numpy(p)).numpy(),
                                   np.asarray(script._field_c2w(jnp.asarray(p))), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tpc.pose_error(torch.from_numpy(noisy), torch.from_numpy(gt)),
                               script.pose_error(jnp.asarray(noisy), jnp.asarray(gt)),
                               rtol=1e-4, atol=1e-6)


def test_val_pose_transfer_matches_script(tmp_path):
    """transfer_val_poses against the script's chain (write_transforms_json
    x 3, compare_pose sim3, load, parse_raw_camera_barf) on the same train,
    refined and val poses (atol 1e-5), each file in --out_dir."""
    from myc_nerfs_tpu.evaluation.pose_export import (compare_pose, load_transforms_json,
                                                      write_transforms_json)
    from myc_nerfs_tpu.geom.conventions import parse_raw_camera_barf
    from myc_nerfs_tpu.geom import lie as jlie, pose as jpose

    tr, val = _poses(2, 9), _poses(3, 3)
    sim = jpose.compose_pair(jlie.se3_to_SE3(jnp.asarray([[0.1, -0.2, 0.05, 0.3, 0.1, -0.2]]))[0],
                             jnp.asarray(tr))
    refined = np.asarray(sim) * np.asarray([1, 1, 1, 1.3], np.float32)
    p = {k: str(tmp_path / f"j_{k}.json") for k in ("vo", "vn", "to", "tn")}
    write_transforms_json(p["vo"], jnp.asarray(tr))
    write_transforms_json(p["vn"], jnp.asarray(refined))
    write_transforms_json(p["to"], jnp.asarray(val))
    compare_pose(p["vo"], p["vn"], p["to"], p["tn"], method="sim3")
    c2w, _, _ = load_transforms_json(p["tn"])
    ref = [np.asarray(parse_raw_camera_barf(c2w[j])) for j in range(3)]
    out = tpc.transfer_val_poses(str(tmp_path), torch.from_numpy(tr), torch.from_numpy(refined),
                                 torch.from_numpy(val))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    for k in ("val_old", "val_new", "test_old", "test_new"):
        assert os.path.exists(tmp_path / f"chain_{k}.json")


SMALL = ["--device", "cpu", "--small", "--views", "6", "--size", "16", "--batch", "128",
         "--rand_rays", "96", "--samples", "8", "--tt_rays", "64"]


def _events(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_chain_cpu_smoke(tmp_path, capsys):
    """The whole chain at a tiny cut (6 views at 16^2, GARF 32 steps, each
    NGP leg 32 steps, 20 test-time iterations): every event in order, the
    transforms in --out_dir, finite PSNRs for the three legs before and
    after test-time optimisation, each view's iterations and stop reason,
    no kernel launched on the CPU."""
    res = tpc.main(SMALL + ["--garf_steps", "32", "--ngp_steps", "32", "--log_every", "16",
                            "--tt_iters", "20", "--out_dir", str(tmp_path)])
    ev = _events(capsys.readouterr().out)
    names = [e["event"] for e in ev]
    assert names == ["pose_chain_start", "pose_chain_garf_log", "pose_chain_garf_log",
                     "pose_chain_garf_done", "pose_chain_export", "pose_chain_compare_pose",
                     "pose_chain_ngp", "pose_chain_ngp", "pose_chain_ngp", "pose_chain_done"]
    assert [e["cameras"] for e in ev if e["event"] == "pose_chain_ngp"] == list(tpc.LEGS)
    for e in ev:
        if e["event"] == "pose_chain_ngp":
            assert e["steps"] == 32 and np.isfinite(e["val_psnrs"] + e["val_psnrs_tt"]).all()
            assert [t["iters"] for t in e["tt"]] == [20, 20, 20]
            assert {t["reason"] for t in e["tt"]} <= {"stop_loss", "plateau", "max_iter"}
            assert set(e["train_launches"].values()) == {0}
    done = ev[3]
    assert done["rot_ratio"] == pytest.approx(done["rot_err_deg"] / done["rot_err_deg_init"])
    assert res["legs"]["refined"]["trainer"] is not None
    assert len(res["val_poses"]["refined"]) == 3
    with open(tmp_path / "transforms_train.json") as f:
        assert len(json.load(f)["frames"]) == 3


def test_chain_gate_and_skip(tmp_path, capsys):
    """--gate_frac 0.5 sets the correction's start at half the GARF steps,
    --skip gt,noisy,refined --no_tt runs the GARF leg alone (F5's run)."""
    res = tpc.main(SMALL + ["--garf_steps", "16", "--gate_frac", "0.5", "--skip",
                            "gt,noisy,refined", "--no_tt", "--out_dir", str(tmp_path)])
    ev = _events(capsys.readouterr().out)
    assert ev[0]["start_pose_correct"] == 8
    assert [e["event"] for e in ev][-3:] == ["pose_chain_garf_done", "pose_chain_export",
                                             "pose_chain_compare_pose"]
    assert res["legs"] == {} and res["done"] is None


def test_chain_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tpc.main(["--out_dir", str(tmp_path)])


# --- F5: GARF across the correction gate's opening -------------------------------

GATE_STEPS, GATE_AT, GATE_VIEWS, GATE_SIZE = 50, 25, 4, 20


def test_garf_gate_opening_matches_jax():
    """GARF (4 x 32 gaussian layers, noise 0.05, the correction gated at step
    25) for 50 steps, each step from the JAX state of that step (read back
    through the checkpoint) on the JAX step's draws: the loss (rtol 1e-5),
    the pose corrections and Adam's pose moments (within 2e-3 of their
    scale; GARF's gaussians magnify rounding) and the counts agree at
    every step, before, at and after the gate; no correction moves before
    step 25. Both packages count the pose Adam's steps from step 0 (optax
    increments its count on the zero gradients before the gate), so the
    bias corrections are ~1 when the gate opens."""
    import jax
    import jax.numpy as jnp

    from myc_nerfs_tpu.core import checkpoint as jck
    from myc_nerfs_tpu.data import synthetic as jsyn
    from myc_nerfs_tpu.train import nerf_trainer as jnt
    from myc_nerfs_tpu_torch.core import checkpoint as tck
    from myc_nerfs_tpu_torch.core.bridge import nerf_params_from_numpy
    from myc_nerfs_tpu_torch.train import nerf_trainer as tnt

    s = jsyn.make_scene(n_views=GATE_VIEWS, H=GATE_SIZE, W=GATE_SIZE, textured=True)
    images, poses, intr = (np.array(x) for x in (s.images, s.poses, s.intr))
    kw = dict(model="garf", widths_feat=(32,) * 4, widths_rgb=(16, 3), skip=(3,),
              depth_range=(1.5, 4.5), sample_intvs=16, rand_rays=96, lr=5e-3, lr_end=1e-3,
              max_iter=GATE_STEPS, refine_pose=True, camera_noise=0.05,
              start_pose_correct_iter=GATE_AT)
    jcfg, tcfg = jnt.NeRFTrainConfig(**kw, mlp_tile=False), tnt.NeRFTrainConfig(**kw)
    _, js = jnt.init_state(jcfg, jax.random.PRNGKey(0), GATE_VIEWS)
    jstep = jax.jit(jnt._make_step_raw(jcfg, jnt.build_model(jcfg), jnp.asarray(images),
                                       jnp.asarray(poses), jnp.asarray(intr)))
    ts = tnt.init_state(tcfg, torch.Generator().manual_seed(1), GATE_VIEWS, "cpu")
    nerf_params_from_numpy(ts.params, jax.tree_util.tree_map(np.asarray, js.params))
    ts = ts._replace(pose_noise=torch.from_numpy(np.array(js.pose_noise)))
    tstep = tnt.make_train_step(tcfg, torch.from_numpy(images), torch.from_numpy(poses),
                                torch.from_numpy(intr))
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax.ckpt")
        for k in range(GATE_STEPS):
            jck.save_checkpoint(path, js, step=k)
            ts, _ = tck.restore_checkpoint(path, ts)
            key = jax.random.PRNGKey(100 + k)
            k_idx, k_depth, _ = jax.random.split(key, 3)
            R = tcfg.rand_rays // GATE_VIEWS
            draws = tnt.StepDraws(
                ray_idx=torch.from_numpy(np.array(jax.random.randint(
                    k_idx, (R,), 0, GATE_SIZE * GATE_SIZE))),
                depth=torch.from_numpy(np.array(jax.random.uniform(
                    k_depth, (GATE_VIEWS, R, tcfg.sample_intvs, 1)))))
            js, jm = jstep(js, key)
            ts, tm = tstep(ts, draws)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
            a, b = ts.se3_refine.numpy(), np.asarray(js.se3_refine)
            if k < GATE_AT:
                assert not a.any() and not b.any(), k
            else:
                assert np.abs(b).max() > 0
                np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * np.abs(b).max())
            assert int(ts.opt_state_pose.count) == int(js.opt_state_pose[0].count) == k + 1
            for m, j in ((ts.opt_state_pose.mu[0], js.opt_state_pose[0].mu),
                         (ts.opt_state_pose.nu[0], js.opt_state_pose[0].nu)):
                j = np.asarray(j)
                np.testing.assert_allclose(m.numpy(), j, rtol=0,
                                           atol=2e-3 * max(np.abs(j).max(), 1e-30))
