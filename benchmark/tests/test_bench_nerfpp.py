"""The NeRF++ cell, tensorf_scarf.train, added by new files alone: its
configuration is Scarf.txt as it loads, the harness runs it through the
catalog at a small size on the CPU with its own limits and its check
passes; a step that leaves its state unchanged and a loss over half the
batch each read ``correct`` false; on a card, the reference in TF32 (the
control) and on half of each batch read past a limit at the cell's size.

``sizes.py`` holds the other cells' small sizes; this cell's is registered
in its ``TINY`` from here (``NERFPP_TINY``), which the directory's other
tests read once pytest has collected this module, so run them together:
``python -m pytest benchmark/tests``."""
import json
import time

import pytest
import torch

from benchmark import control
from benchmark.lib import catalog, harness
from benchmark.tests import sizes
from conftest import ROOT

CELL = "tensorf_scarf.train"
# a (47, 16, 47) grid in Scarf's box, 32 foreground and 16 background samples
# per ray, 64 rays a step, two 16x16 views
NERFPP_TINY = {"config": {"tensorf": {"batch_size": 64, "bg_samples": 16, "nSamples": 32},
                          "stage": {"n_voxels": 36864},
                          "scene": {"views": 2, "H": 16, "W": 16, "gt_samples": 32}},
               "mix": {"warm_steps": 3, "trace_steps": 2}}
sizes.TINY.setdefault(CELL, NERFPP_TINY)


def _run(trace=False, seed=2 ** 31 + 11):
    return harness.run_cell(ROOT, CELL, seed, 0.0, trace, "cpu", time.perf_counter(),
                            NERFPP_TINY)


def test_the_configuration_is_scarf_as_it_loads():
    from myc_nerfs_tpu_torch.cli.tensorf_train import parse_txt_config

    bench = catalog.load(ROOT)
    cfg = catalog.config(ROOT, bench, "tensorf_scarf")
    assert cfg["family"] == "tensorf_nerfpp" and cfg["reduced"] == ["datadir"]
    assert cfg["tensorf"] == json.loads(json.dumps(parse_txt_config(
        str(ROOT / "configs/tensorf/Scarf.txt"))))
    assert catalog.cell(bench, CELL)["chips"] == 1


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_small_and_is_correct(trace):
    line = _run(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line
    work = line["work"]
    assert work["grid"] == [47, 16, 47] and work["fg_samples_per_ray"] == 32
    assert work["bg_samples_per_step"] == 64 * 16
    assert 0.0 < work["shaded_share"] < work["gated_share"] < 1.0
    assert 0.0 < work["bg_ray_share"] < 1.0
    assert "memory_peak_bytes" in work
    if trace:
        # no device here: the kernel rooflines find nothing, the spans do
        assert "bg_idle_ms_per_step.train" in line["metrics"]
        assert "mfu.train" in line["metrics"]
        assert "mlp_gemm_roofline.train" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}


def _unchanged(monkeypatch):
    from myc_nerfs_tpu_torch.train import tensorf_trainer

    def adam_step(sched, betas, eps, grads, state):
        return [torch.zeros_like(g) for g in grads], state

    monkeypatch.setattr(tensorf_trainer, "adam_step", adam_step)


def _half_batch(monkeypatch):
    from myc_nerfs_tpu_torch.train.tensorf_trainer import TensoRFTrainer

    loss = TensoRFTrainer.loss

    def half(self, rays, rgbs, draws, params=None, step=None):
        n = rays.shape[0] // 2
        return loss(self, rays[:n], rgbs[:n], tuple(d[:n] for d in draws), params, step)

    monkeypatch.setattr(TensoRFTrainer, "loss", half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = _run()
    assert line["correct"] is False, line["checks"]


def test_the_mlp_gemm_bound_counts_the_traced_rows(monkeypatch):
    """The bound reads the background rows from the program's traced
    counter and the shaded rows from the family's records; without either
    it reads None."""
    from benchmark.lib import spans, work
    from benchmark.lib.readings import Readings
    from benchmark.reference import tensorf_nerfpp as pref

    spec = pref.nerfpp_spec(catalog.config(ROOT, catalog.load(ROOT), "tensorf_scarf"))
    bound = catalog.bound(ROOT, "mlp_gemm")
    r = Readings(ROOT, "train", None, 1, spec.fg, "f32",
                 {"mlp_gemm": [(spec, torch.tensor(1000))]})
    monkeypatch.setattr(spans, "traced_counts", lambda: {})
    assert bound(r) is None
    monkeypatch.setattr(spans, "traced_counts", lambda: {"nerfpp.bg_samples": 1024 * 512})
    got = bound(r)
    # the background alone: 92.6 GFLOP forward and 182.5 backward (no input
    # gradient of the first layer) at 495/3 TFLOP/s is 1.667 ms; its inputs,
    # outputs and weights move in a few microseconds; the shaded rows add
    # the basis and MLP_Fea
    rows = 1024 * 512
    macs = sum(a * b for a, b in pref.bg_widths(spec))
    first = pref.bg_widths(spec)[0]
    flops = 2.0 * rows * (3 * macs - first[0] * first[1])
    assert 1.66e-3 < 3.0 * flops / work.FLOPS["tf32"] < got < 1.75e-3
    assert bound(Readings(ROOT, "train", None, 1, spec.fg, "f32", {})) is None


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["control", "half"])
def test_the_control_and_the_half_batch_are_not_correct(cuda_device, side):
    limits = catalog.limits(ROOT, CELL)
    readings = control.control_side(CELL, 9001, cuda_device, side=side)
    assert any(readings[k] > limits[k] for k in limits), (readings, limits)
