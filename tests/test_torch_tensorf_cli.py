"""The port's TensoRF CLI against the JAX package's: parse_txt_config and
build_configs on every configs/tensorf/*.txt; checkpoints both ways (the
port restores a JAX checkpoint with an alpha mask, after a shrink and two
steps, and renders its rays as the JAX forward does; the JAX
restore_tensorf_ckpt reads the port's file); --resume continuing at the
stored step with the voxel schedule advanced; train, --render_only and
--export_mesh on the CPU; no card and no --device cpu: a non-zero exit."""
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from myc_nerfs_tpu.cli import tensorf_train as jcli
from myc_nerfs_tpu.models import tensorf as jtf
from myc_nerfs_tpu_torch.cli import tensorf_train as tcli
from myc_nerfs_tpu_torch.core.bridge import tensorf_params_tree, tree_get
from myc_nerfs_tpu_torch.models import tensorf as ttf
from myc_nerfs_tpu_torch.train import tensorf_trainer as ttt

torch.set_num_threads(1)

CONFIGS = sorted(glob.glob("configs/tensorf/*.txt"))
DEMO = "configs/tensorf/demo_synthetic.txt"


@pytest.mark.parametrize("path", CONFIGS)
def test_configs_match_jax(path):
    """The same parsed dict, and every field of the port's TensoRFConfig and
    TensoRFTrainConfig equal to the JAX one's."""
    a = tcli.parse_txt_config(path)
    assert a == jcli.parse_txt_config(path)
    jm, jt = jcli.build_configs(a)
    tm, tt_ = tcli.build_configs(a)
    for f in dataclasses.fields(tm):
        assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert dataclasses.asdict(tt_) == dataclasses.asdict(jt)


def _demo(tmp_path, **kw):
    """demo_synthetic.txt's dict with its output under tmp_path, cut to a
    3-view 12^2 scene."""
    a = jcli.parse_txt_config(DEMO)
    a.update(basedir=str(tmp_path), synthetic_size=12, synthetic_views=3, batch_size=128, **kw)
    return a


def _write(a, path):
    with open(path, "w") as f:
        for k, v in a.items():
            f.write(f"{k} = {v}\n")
    return str(path)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_checkpoints_both_ways(tmp_path):
    """A JAX trainer with a centred density bump, an alpha-mask update, a
    shrink and two train steps, saved by the JAX CLI: the port restores it
    for training (params, both Adams, aabb, alpha volume, stage, step equal)
    and renders 256 of its rays as the JAX forward does (rtol 1e-5 / atol
    1e-6); the port's own save of that state is read by the JAX
    restore_tensorf_ckpt into the same tree."""
    a = _demo(tmp_path, upsamp_list=[100], update_AlphaMask_list=[100], N_voxel_init=1728,
              alpha_mask_thre=0.2, density_shift=-1.0)
    jm, jt = jcli.build_configs(a)
    jm = dataclasses.replace(jm, density_sample_budget=0, app_sample_budget=0)
    rays, rgbs, aabb, _ = jcli.load_rays(a)
    jtr = jcli.build_family_trainer(a, jm, jt, aabb, jax.random.PRNGKey(0))
    p = dict(jtr.params)
    g = [jnp.exp(-jnp.linspace(-1, 1, n) ** 2 / 0.2) for n in jtr.geom.grid_size]
    p["density_plane"] = tuple(pl + 0.5 * jnp.outer(g[jtf.MAT_MODE[i][1]], g[jtf.MAT_MODE[i][0]])
                               for i, pl in enumerate(p["density_plane"]))
    p["density_line"] = tuple(ln + g[jtf.VEC_MODE[i]] for i, ln in enumerate(p["density_line"]))
    jtr.params = p
    jtr.buffers, new_aabb = jtf.update_alpha_mask(jm, jtr.geom, jtr.params, jtr.buffers, (9, 10, 11))
    jtr.params, jtr.buffers, size = jtf.shrink(jm, jtr.geom, jtr.params, jtr.buffers, new_aabb)
    jtr.geom = jtf.compute_stage_geom(jm, np.asarray(jtr.buffers["aabb"]), size, jt.n_samples_cap)
    jtr._rebuild(lr_scale=0.5)
    jtr.train(rays, rgbs, n_iters=2)
    ckpt = str(tmp_path / "jax.ckpt")
    jcli.save_tensorf_ckpt(ckpt, jtr, "TensorVMSplit")
    assert size != tuple(ttt.n_to_reso(1728, aabb))

    tm, tt_ = tcli.build_configs(a)
    ttr = tcli.build_family_trainer(a, tm, tt_, aabb, torch.Generator().manual_seed(3), "cpu")
    tcli.restore_tensorf_ckpt(ckpt, ttr, for_training=True)
    assert tuple(ttr.geom) == tuple(jtr.geom) and ttr.global_step == 2 and ttr.lr_scale == 0.5
    jparams = jax.tree_util.tree_map(np.asarray, jtr.params)
    tparams = tensorf_params_tree(ttr.params)
    for path, v in _flat(tparams):
        np.testing.assert_array_equal(v, tree_get(jparams, path))
    for name, opt in (("spatial", ttr.opt_spatial), ("net", ttr.opt_net)):
        inner = jtr.opt_state.inner_states[name].inner_state[0]
        assert int(opt.count) == int(inner.count) == 2
        for path, t in zip(ttf.param_groups(ttr.params)[name == "net"], opt.mu):
            np.testing.assert_array_equal(t.numpy(), np.asarray(tree_get(inner.mu, path)))
    for k in ("aabb", "alpha_aabb", "alpha_volume", "alpha_volume_dil"):
        np.testing.assert_array_equal(ttr.buffers[k].numpy(), np.asarray(jtr.buffers[k]))
    some = np.array(rays[::7][:256])
    j = jtf.tensorf_forward(jm, jtr.geom, jtr.params, jtr.buffers, jnp.asarray(some), None)
    rgb, depth = ttr.render_rays(torch.from_numpy(some), chunk=100)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j.rgb_map), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j.depth_map), rtol=1e-5, atol=1e-6)
    assert float((1 - np.asarray(j.rgb_map)).max()) > 0.05  # not all background

    mine = str(tmp_path / "port.ckpt")
    tcli.save_tensorf_ckpt(mine, ttr, "TensorVMSplit")
    assert json.load(open(mine + ".json")) == json.load(open(ckpt + ".json"))
    jtr2 = jcli.build_family_trainer(a, jm, jt, aabb, jax.random.PRNGKey(9))
    jcli.restore_tensorf_ckpt(mine, jtr2, for_training=True)
    assert tuple(jtr2.geom) == tuple(jtr.geom) and jtr2.global_step == 2
    for a_, b_ in zip(jax.tree_util.tree_leaves(serialization.to_state_dict(
            {"p": jtr2.params, "o": jtr2.opt_state})), jax.tree_util.tree_leaves(
            serialization.to_state_dict({"p": jtr.params, "o": jtr.opt_state}))):
        np.testing.assert_array_equal(np.asarray(a_), np.asarray(b_))
    np.testing.assert_array_equal(np.asarray(jtr2.buffers["alpha_volume"]),
                                  np.asarray(jtr.buffers["alpha_volume"]))


def test_cli_train_render_mesh_resume(tmp_path, monkeypatch):
    """cli.tensorf_train on the CPU: 5 steps (upsample at 3), --resume to 9
    (the upsample at 7 takes the schedule's second size), --render_only
    (PSNR and SSIM in mean.txt, .npy images), --export_mesh (a non-empty
    .ply, of the checkpoint with a centred density bump added: 9 steps
    leave no surface at the mesh level); without --device cpu and with no
    card: a non-zero exit."""
    a = _demo(tmp_path, upsamp_list=[3, 7], update_AlphaMask_list=[100], n_iters=5)
    cfg = _write(a, tmp_path / "demo.txt")
    out = tcli.main(["--config", cfg, "--device", "cpu", "--log_every", "0"])
    meta = json.load(open(os.path.join(out, "demo.ckpt.json")))
    tcfg = tcli.build_configs(a)[1]
    schedule = ttt.n_voxel_schedule(tcfg)
    aabb = np.asarray(a["bbox"], np.float32).reshape(2, 3)
    assert meta["global_step"] == 5 and meta["grid_size"] == ttt.n_to_reso(schedule[0], aabb)
    tcli.main(["--config", cfg, "--device", "cpu", "--resume", "1", "--n_iters", "9",
               "--log_every", "0"])
    meta = json.load(open(os.path.join(out, "demo.ckpt.json")))
    assert meta["global_step"] == 9 and meta["grid_size"] == ttt.n_to_reso(schedule[1], aabb)
    tcli.main(["--config", cfg, "--device", "cpu", "--render_only", "1"])
    mean = dict(line.split() for line in open(os.path.join(out, "imgs_test_all", "mean.txt")))
    assert 5.0 < float(mean["psnr"]) < 60.0 and 0.0 < float(mean["ssim"]) <= 1.0
    assert os.path.exists(os.path.join(out, "imgs_test_all", "002.npy"))
    tm, tt_ = tcli.build_configs(a)
    trainer = tcli.build_family_trainer(a, tm, tt_, aabb, device="cpu")
    tcli.restore_tensorf_ckpt(os.path.join(out, "demo.ckpt"), trainer, for_training=True)
    with torch.no_grad():
        for i, pl in enumerate(trainer.params["density_plane"]):
            C, H, W = pl.shape
            v, u = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W),
                                  indexing="ij")
            pl += 2.0 * torch.exp(-(u ** 2 + v ** 2) / 0.1)
        for line in trainer.params["density_line"]:
            line += 1.0
    tcli.save_tensorf_ckpt(os.path.join(out, "demo.ckpt"), trainer, "TensorVMSplit")
    tcli.main(["--config", cfg, "--device", "cpu", "--export_mesh", "1"])
    ply = open(os.path.join(out, "demo.ply")).read().splitlines()
    assert ply[0] == "ply" and int(ply[2].split()[-1]) > 0 and int(ply[6].split()[-1]) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["--config", cfg, "--n_iters", "1"])
    assert e.value.code not in (0, None)


def test_cli_blender_split(tmp_path):
    """A blender dataset (3 train PNGs, a test JSON without images): train,
    then --render_only --render_path: the GT-less test views at the train
    split's resolution and the orbit's frames (tests/test_cli.py's JAX
    case, on the port)."""
    from PIL import Image

    ds = tmp_path / "scene"
    os.makedirs(ds / "train")
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        Image.fromarray((rng.uniform(0, 1, (10, 10, 3)) * 255).astype(np.uint8)).save(
            ds / "train" / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[:3, 3] = [0, 0, 2.5 + 0.2 * i]
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (ds / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.8,
                                                          "frames": frames}))
    (ds / "transforms_test.json").write_text(json.dumps(
        {"camera_angle_x": 0.8, "frames": [{"file_path": f"./test/r_{i}",
                                            "transform_matrix": frames[i]["transform_matrix"]}
                                           for i in range(2)]}))
    cfg = tmp_path / "tiny.txt"
    cfg.write_text(f"expname = tiny\nbasedir = {tmp_path}\ndatadir = {ds}\n"
                   "bbox = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]\nn_iters = 4\nbatch_size = 64\n"
                   "N_voxel_init = 4096\nN_voxel_final = 4096\nupsamp_list = [100000]\n"
                   "update_AlphaMask_list = [100000]\nnSamples = 16\nn_lamb_sigma = [2, 2, 2]\n"
                   "n_lamb_sh = [4, 4, 4]\ndata_dim_color = 6\nfeatureC = 16\n"
                   "render_path_frames = 3\n")
    tcli.main(["--config", str(cfg), "--device", "cpu"])
    out = tcli.main(["--config", str(cfg), "--device", "cpu", "--render_only", "1",
                     "--render_path", "1"])
    test_imgs = sorted(os.listdir(os.path.join(out, "imgs_test_all")))
    assert test_imgs == ["000.npy", "000.png", "000_depth.npy", "000_depth.png", "001.npy",
                         "001.png", "001_depth.npy", "001_depth.png"]
    assert np.load(os.path.join(out, "imgs_test_all", "001.npy")).shape == (10, 10, 3)
    path = os.listdir(os.path.join(out, "imgs_path_all"))
    assert {"000.npy", "001.npy", "002.npy"} <= set(path)
