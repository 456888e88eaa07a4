"""The umbrella entry points against the JAX package's: cli/tensorf_budget
against scripts/tensorf_budget.py (the protocol: start fields, chunks,
grids and ray counts), a CPU run crossing every event with the schedule
rescaled, and the split run (--stop_at, --resume) equal to the straight
one; cli/test_scenes (the synthetic leg's images, the skips without data,
the Easyship copy) against cli/test_scenes of the JAX package; and
entry() against __graft_entry__.entry() on the JAX weights."""
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.cli import tensorf_budget as tbudget

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(tmp_path, upsamp, masks, name="Coffee.txt"):
    """configs/tensorf/Coffee.txt with the voxel counts and the event lists
    rescaled (as chip_smoke phase 19 cuts them)."""
    src = open(os.path.join(REPO, "configs", "tensorf", "Coffee.txt")).read()
    src = (src.replace("N_voxel_init = 2097156", "N_voxel_init = 4096")
              .replace("N_voxel_final = 27000000", "N_voxel_final = 32768")
              .replace("upsamp_list = [2000, 3000, 4000, 5500, 7000]", f"upsamp_list = {upsamp}")
              .replace("update_AlphaMask_list = [2000, 4000]",
                       f"update_AlphaMask_list = {masks}"))
    path = tmp_path / name
    path.write_text(src)
    return str(path)


SMALL = ["--size", "16", "--views", "12", "--holdout", "6", "--batch", "256"]


def _events(text, kind=None):
    ev = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return [e for e in ev if kind is None or e["event"] == kind]


def test_budget_protocol_matches_script(tmp_path, capsys, monkeypatch):
    """20 steps in chunks of 10 on the same rescaled config, upsamples at 4,
    6, 8, 11, 14 and the masks past the run: the start line's protocol
    (train rays, val views, events) and each chunk's step, grid and ray
    count equal the JAX script's."""
    cfg = _config(tmp_path, "[4, 6, 8, 11, 14]", "[1000, 2000]")
    args = ["--config", cfg, "--steps", "20", "--val_every", "10"] + SMALL
    tbudget.main(args + ["--ckpt", str(tmp_path / "t.ckpt"), "--device", "cpu"])
    port = _events(capsys.readouterr().out)
    spec = importlib.util.spec_from_file_location(
        "tensorf_budget_script", os.path.join(REPO, "scripts", "tensorf_budget.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["tensorf_budget.py", "--cpu", "--ckpt",
                                      str(tmp_path / "j.msgpack")] + args)
    mod.main()
    ref = _events(capsys.readouterr().out)
    keys = ("train_rays", "val_views", "upsamp", "alphamask", "steps", "views", "size")
    assert {k: port[0][k] for k in keys} == {k: ref[0][k] for k in keys}
    logs = [(e["step"], e["grid_size"], e["n_train_rays"]) for e in port
            if e["event"] == "tensorf_budget_log"]
    assert logs == [(e["step"], e["grid_size"], e["n_train_rays"]) for e in ref
                    if e["event"] == "tensorf_budget_log"]
    assert all(np.isfinite(e["val_psnr"]) for e in port if e["event"] == "tensorf_budget_log")


def test_budget_events_and_split_run(tmp_path, capsys):
    """Every event inside 20 steps (upsamples at 4, 6, 8, 11, 14, masks at 4
    and 8, so the shrink and the refilter run): the grid grows, the train
    rays are refiltered once; the run split by --stop_at 10 and --resume
    writes the same checkpoint, bit for bit, and the same log lines (the
    seconds aside) as the straight run."""
    cfg = _config(tmp_path, "[4, 6, 8, 11, 14]", "[4, 8]")
    args = ["--config", cfg, "--steps", "20", "--val_every", "10", "--device", "cpu"] + SMALL
    straight = tbudget.main(args + ["--ckpt", str(tmp_path / "a.ckpt")])
    tbudget.main(args + ["--ckpt", str(tmp_path / "b.ckpt"), "--stop_at", "10"])
    resumed = tbudget.main(args + ["--ckpt", str(tmp_path / "b.ckpt"), "--resume"])
    out = capsys.readouterr().out
    assert len(_events(out, "tensorf_budget_resumed")) == 1
    assert (tmp_path / "a.ckpt").read_bytes() == (tmp_path / "b.ckpt").read_bytes()
    timing = ("it_s", "wall_s", "t_train_s", "t_val_s", "t_ckpt_s")

    def strip(line):
        return {k: v for k, v in line.items() if k not in timing}

    assert strip(straight["log"][-1]) == strip(resumed["log"][-1])
    first, last = straight["log"]
    assert np.prod(last["grid_size"]) > np.prod(first["grid_size"])
    assert last["n_train_rays"] <= 12 * 16 * 16 * 10 // 12


def test_budget_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tbudget.main(["--steps", "1"])


# --- cli/test_scenes -------------------------------------------------------------

def test_test_scenes_synthetic(tmp_path, monkeypatch):
    """--synthetic on the CPU: TensoRF demo_synthetic (50 steps, then
    --render_only) and NGP demo_synthetic (50 steps, then a test pass from
    its checkpoint) put their rendered images in result/demo_tensorf and
    result/demo_ngp (the JAX driver's two folders), depth maps excepted."""
    from myc_nerfs_tpu_torch.cli import test_scenes

    monkeypatch.chdir(tmp_path)
    out = test_scenes.main(["--synthetic", "--configs_root", os.path.join(REPO, "configs"),
                            "--device", "cpu"])
    assert out == "result"
    tf_imgs = sorted(os.listdir(tmp_path / "result" / "demo_tensorf"))
    ngp_imgs = sorted(os.listdir(tmp_path / "result" / "demo_ngp"))
    assert tf_imgs and ngp_imgs and not any("depth" in n for n in tf_imgs)
    assert {"r_0.npy", "r_0.png"} <= set(ngp_imgs)
    img = np.load(tmp_path / "result" / "demo_ngp" / "r_0.npy")
    assert np.isfinite(img).all() and img.shape == (24, 24, 3)
    # the test pass rendered the trained field (resumed from the checkpoint)
    assert os.path.exists(tmp_path / "logs" / "demo" / "model.ckpt")


def test_test_scenes_without_data(tmp_path, monkeypatch):
    """Without scene data both drivers skip every scene and leave an empty
    result folder; with Easyship's images and a refine folder, the port
    copies the images beside the refined poses (test.py:25-28) before its
    NGP pass."""
    from myc_nerfs_tpu.cli import test_scenes as jscenes
    from myc_nerfs_tpu_torch.cli import test_scenes as tscenes

    monkeypatch.chdir(tmp_path)
    common = ["--data_root", str(tmp_path / "data"), "--configs_root",
              os.path.join(REPO, "configs")]
    assert tscenes.main(common + ["--result_dir", "port", "--device", "cpu"]) == "port"
    assert jscenes.main(common + ["--result_dir", "jax"]) == "jax"
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == []
    (tmp_path / "data" / "Easyship" / "test").mkdir(parents=True)
    (tmp_path / "data" / "Easyship" / "test" / "r_0.png").write_bytes(b"x")
    (tmp_path / "refine").mkdir()
    with pytest.raises(FileNotFoundError):  # then the NGP pass finds no transforms JSON
        tscenes.main(common + ["--result_dir", "port", "--refine_dir", str(tmp_path / "refine"),
                               "--device", "cpu"])
    assert (tmp_path / "refine" / "test" / "r_0.png").read_bytes() == b"x"


def test_test_scenes_refuses_without_a_card(tmp_path, monkeypatch):
    from myc_nerfs_tpu_torch.cli import test_scenes

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        test_scenes.main(["--synthetic", "--configs_root", os.path.join(REPO, "configs")])


# --- entry ---------------------------------------------------------------------

def test_entry_matches_jax():
    """entry('cpu') with the JAX entry()'s weights and grid loaded: the same
    model (16 levels, brick3, n_coarse 256, n_samples 32, 1024 rays around
    the centre) renders the same rgb (atol 1e-5), not all background."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as graft
    from myc_nerfs_tpu_torch.core.bridge import load_ngp_params, occupancy_from_numpy
    from myc_nerfs_tpu_torch.entry import entry

    jfn, (params, occ, o, d) = graft.entry()
    ref = np.asarray(jax.jit(jfn)(params, occ, o, d))
    fn, (model, state, rays_o, rays_d) = entry("cpu")
    assert model.cfg.grid.n_levels == 16 and model.cfg.grid_impl == "brick3"
    load_ngp_params(model, jax.tree_util.tree_map(np.asarray, params))
    jstate = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, occ._asdict()))
    for a, b in ((state.density_grid, jstate.density_grid), (state.bitfield, jstate.bitfield)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(rays_o.numpy(), np.asarray(o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rays_d.numpy(), np.asarray(d), rtol=0, atol=1e-6)
    rgb = fn(model, state, rays_o, rays_d)
    assert rgb.shape == (1024, 3) and torch.isfinite(rgb).all()
    np.testing.assert_allclose(rgb.numpy(), ref, rtol=0, atol=1e-5)
    assert float((rgb - 1.0).abs().max()) > 1e-3


def test_entry_refuses_without_a_card():
    from myc_nerfs_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        entry()
