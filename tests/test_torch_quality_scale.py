"""The port's quality harness (cli/quality_scale.py) on the CPU at a tiny
size: each variant trains, renders its held-out views and prints its JSON
line; the fused flagship resumes from its checkpoint. The JAX harness's
settings (SCALE/OFF, val views 0, n/3, 2n/3, the trainer configuration)
against scripts/quality_scale.py's."""
import json

import pytest
import torch

from myc_nerfs_tpu_torch.cli import quality_scale as qs

torch.set_num_threads(1)

TINY = ["--views", "6", "--size", "12", "--batch", "64", "--n_coarse", "32",
        "--device", "cpu"]


@pytest.fixture(autouse=True)
def few_grid_samples(monkeypatch):
    """Occupancy updates of 1024 samples each (the harness takes 2^16)."""
    monkeypatch.setattr(qs, "GRID_SAMPLES", 1024)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", [["--variant", "brick3"], ["--variant", "hash"],
                                     ["--variant", "flagship", "--lr", "1e-3", "--f32"]])
def test_each_variant_trains_and_reports(variant, capsys):
    qs.main(variant + TINY + ["--steps", "16"])
    out = _last_json(capsys)
    assert out["steps"] == 16 and len(out["val_psnrs"]) == 3
    assert out["val_psnr"] > 0 and out["device"] == "cpu"


def test_fused_flagship_resumes_from_its_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "q.ckpt")
    args = ["--variant", "flagship", "--fused", "--f32", "--lr", "1e-3", "--ckpt", ckpt] + TINY
    qs.main(args + ["--steps", "16"])
    first = _last_json(capsys)
    qs.main(args + ["--steps", "32", "--resume"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[1]) == {"event": "resumed", "step": 16}
    assert json.loads(lines[-1])["steps"] == 32 and first["fused"]


def test_settings_match_the_jax_harness():
    args = qs.parse_args(["--variant", "hash", "--views", "36"])
    assert qs.val_ids_of(args) == [0, 12, 24]
    trainer = qs.build_trainer(qs.parse_args(["--variant", "hash", "--device", "cpu"]),
                               "cpu", torch.Generator().manual_seed(0))
    assert trainer.model.cfg.grid_impl == "hash" and trainer.model.cfg.use_bf16
    assert not trainer.rcfg.fused_march and trainer.rcfg.compact_source == "network"
    assert (trainer.rcfg.near_distance, trainer.rcfg.n_samples) == (0.05, 64)
    assert (trainer.cfg.n_rays_per_batch, trainer.cfg.decay_start,
            trainer.cfg.update_den_freq) == (8192, 20000, 16)
    cascade = qs.parse_args(["--scene", "cascade", "--views", "72"])
    assert qs.val_ids_of(cascade) == [1, 19, 37, 55]
    with pytest.raises(SystemExit):
        qs.main(["--variant", "brick3", "--fused", "--device", "cpu"])
