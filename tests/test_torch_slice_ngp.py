"""The ported slice end to end, both ways round.

- Render: the JAX run_net trains configs/ngp/demo_synthetic.py for 16
  steps and saves model.ckpt; the JAX and the port's ``run_net --task
  test`` render the same eval views from it, and their images and PSNRs
  agree.
- Train: the port's ``run_net --task train`` trains the same config for
  three blocks; its train PSNR rises, its model.ckpt restores in the JAX
  package, and the JAX ``--task test`` renders it as the port does."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Train 16 steps and render the test views with the JAX package."""
    from myc_nerfs_tpu.cli import run_net as jax_run_net

    root = tmp_path_factory.mktemp("slice")
    cfg = root / "demo_ckpt.py"
    # 9 views: the JAX run_net caches the scene in a file named by its view
    # count, so a run of its other tests never shares this one's cache
    cfg.write_text(f"_base_ = {os.path.join(REPO, 'configs/ngp/demo_synthetic.py')!r}\n"
                   "load_ckpt = True\nsynthetic_views = 9\n")
    jdir = root / "jax"
    jax_run_net.main(["--config-file", str(cfg), "--task", "train",
                      "--steps", "16", "--save_dir", str(jdir)])
    jax_run_net.main(["--config-file", str(cfg), "--task", "test",
                      "--save_dir", str(jdir)])
    return root, cfg, jdir


def _mean_psnr(path):
    lines = [ln for ln in open(path).read().splitlines() if ln.startswith("mean")]
    return float(lines[-1].split()[1])


def test_port_renders_jax_checkpoint(jax_run):
    """Port images within 1/255 of JAX's on 99% of pixels: both render from
    one checkpoint, and a sample whose inverse-CDF rank lands on a bin edge
    may fall in the neighbouring bin on one side only. Mean PSNR within
    0.05 dB (the port computes it against its own, equal-to-1e-6 ground
    truth)."""
    from PIL import Image

    from myc_nerfs_tpu_torch.cli import run_net

    root, cfg, jdir = jax_run
    tdir = root / "port"
    tdir.mkdir()
    for name in ("model.ckpt", "model.ckpt.json"):
        shutil.copy(jdir / name, tdir / name)
    run_net.main(["--config-file", str(cfg), "--task", "test",
                  "--save_dir", str(tdir), "--device", "cpu"])
    n_views = 4  # demo_synthetic has no held-out views: the first 4
    for i in range(n_views):
        ref = np.asarray(Image.open(jdir / "test" / f"r_{i}.png"), np.int32)
        out = np.asarray(Image.open(tdir / "test" / f"r_{i}.png"), np.int32)
        rgb = np.load(tdir / "test" / f"r_{i}.npy")
        assert rgb.shape == (24, 24, 3) and np.isfinite(rgb).all()
        np.testing.assert_array_equal(out, (rgb * 255).astype(np.uint8))
        close = (np.abs(out - ref) <= 1).all(-1)
        assert close.mean() >= 0.99, f"view {i}: {close.mean():.4f}"
    jp, tp = _mean_psnr(jdir / "psnr.txt"), _mean_psnr(tdir / "psnr.txt")
    assert abs(jp - tp) < 0.05, (jp, tp)


def test_port_render_task(jax_run):
    from myc_nerfs_tpu_torch.cli import run_net

    root, cfg, jdir = jax_run
    tdir = root / "port_render"
    tdir.mkdir()
    for name in ("model.ckpt", "model.ckpt.json"):
        shutil.copy(jdir / name, tdir / name)
    run_net.main(["--config-file", str(cfg), "--task", "render",
                  "--save_dir", str(tdir), "--device", "cpu"])
    frames = sorted(p for p in os.listdir(tdir / "demo") if p.endswith(".npy"))
    assert len(frames) == 8
    rgb = np.load(tdir / "demo" / frames[0])
    assert rgb.shape == (24, 24, 3) and np.isfinite(rgb).all()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Train 3 blocks (48 steps) with the port's run_net; keep each
    block's metrics."""
    from myc_nerfs_tpu_torch.cli import run_net

    root = tmp_path_factory.mktemp("port_train")
    cfg = root / "demo_train.py"
    # 7 views: a scene cache of its own in the JAX run_net (see jax_run)
    cfg.write_text(f"_base_ = {os.path.join(REPO, 'configs/ngp/demo_synthetic.py')!r}\n"
                   "load_ckpt = True\nsynthetic_views = 7\n")
    pdir = root / "port"
    history = []
    train_loop, val_every = run_net.train_loop, run_net.VAL_EVERY
    run_net.train_loop = lambda *a, **k: history.extend(train_loop(*a, **k)) or history
    run_net.VAL_EVERY = 16  # a val render and a checkpoint after every block
    try:
        run_net.main(["--config-file", str(cfg), "--task", "train", "--steps", "48",
                      "--save_dir", str(pdir), "--device", "cpu"])
    finally:
        run_net.train_loop, run_net.VAL_EVERY = train_loop, val_every
    return root, cfg, pdir, history


def test_port_train_task(port_run):
    """Three blocks of 16 steps: finite losses, a train PSNR that rises
    block on block (0.2 dB at least; the first run rose 11.9 -> 12.2 ->
    12.5), a val PSNR line after each block, and a checkpoint at step
    48."""
    root, cfg, pdir, history = port_run
    assert len(history) == 3
    val = [ln.split() for ln in (pdir / "psnr.txt").read_text().splitlines()
           if not ln.startswith("mean")]
    assert [int(v[0]) for v in val] == [16, 32, 48]
    assert all(np.isfinite(float(v[1])) for v in val)
    psnrs = [float(m["psnr"].mean()) for m in history]
    assert all(torch.isfinite(m["loss"]).all() for m in history)
    assert psnrs[1] > psnrs[0] + 0.2 and psnrs[2] > psnrs[1] + 0.2, psnrs
    assert all(bool(m["finite"].all()) for m in history)
    assert json.loads((pdir / "model.ckpt.json").read_text())["step"] == 48


def test_port_checkpoint_restores_in_jax(port_run):
    """The JAX restore_checkpoint reads the port's model.ckpt into its
    NGPTrainState: params, both Adam moments and both counts, the grid and
    the step equal what the port's own reader finds there, bit for bit."""
    import jax

    from myc_nerfs_tpu.cli import run_net as jax_run_net
    from myc_nerfs_tpu.core.checkpoint import restore_checkpoint as jax_restore
    from myc_nerfs_tpu.core.config import load_config as jax_load_config
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.bridge import param_leaves
    from myc_nerfs_tpu_torch.core.checkpoint import restore_checkpoint
    from myc_nerfs_tpu_torch.core.config import load_config

    root, cfg, pdir, _ = port_run
    jtrainer, _ = jax_run_net.build_trainer(jax_load_config(str(cfg)),
                                            jax.random.PRNGKey(1))
    jstate, meta = jax_restore(str(pdir / "model.ckpt"), jtrainer.state)
    assert meta["step"] == 48 and int(jstate.step) == 48
    trainer, _ = run_net.build_trainer(load_config(str(cfg)), torch.Generator(),
                                       device="cpu")
    state, _ = restore_checkpoint(str(pdir / "model.ckpt"), trainer.state)
    model = state.params
    adam, sched = jstate.opt_state
    assert int(adam.count) == int(sched.count) == int(state.opt_state.count) == 48
    for mine, theirs in ((model.param_list(), jstate.params),
                         (state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        for a, b in zip(mine, param_leaves(model, theirs)):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for k, v in state.occ._asdict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jstate.occ, k)))


def test_jax_renders_port_checkpoint(port_run):
    """The JAX and the port's --task test on the port-trained checkpoint:
    images within 1/255 on 99% of pixels, mean PSNR within 0.05 dB (the
    tolerances of test_port_renders_jax_checkpoint, for the same reason)."""
    from PIL import Image

    from myc_nerfs_tpu.cli import run_net as jax_run_net
    from myc_nerfs_tpu_torch.cli import run_net

    root, cfg, pdir, _ = port_run
    jdir = root / "jax_test"
    jdir.mkdir()
    for name in ("model.ckpt", "model.ckpt.json"):
        shutil.copy(pdir / name, jdir / name)
    jax_run_net.main(["--config-file", str(cfg), "--task", "test",
                      "--save_dir", str(jdir)])
    run_net.main(["--config-file", str(cfg), "--task", "test",
                  "--save_dir", str(pdir), "--device", "cpu"])
    for i in range(4):
        ref = np.asarray(Image.open(jdir / "test" / f"r_{i}.png"), np.int32)
        out = np.asarray(Image.open(pdir / "test" / f"r_{i}.png"), np.int32)
        close = (np.abs(out - ref) <= 1).all(-1)
        assert close.mean() >= 0.99, f"view {i}: {close.mean():.4f}"
    jp, tp = _mean_psnr(jdir / "psnr.txt"), _mean_psnr(pdir / "psnr.txt")
    assert abs(jp - tp) < 0.05, (jp, tp)


def test_run_net_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    """run_net runs on cuda unless --device cpu is given: without a card and
    without the flag it exits with an error, and runs nothing on the CPU."""
    from myc_nerfs_tpu_torch.cli import run_net

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        run_net.main(["--config-file", os.path.join(REPO, "configs/ngp/demo_synthetic.py"),
                      "--task", "test", "--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
