"""The GARF cell, garf_easyship.train, added by new files alone: its
configuration is Easyship.yaml as it loads; the harness runs it through the
catalog at a small size on the CPU with its own limits and its check
passes; a step that leaves its state unchanged, a loss over half of the
pixels and corrections left at zero with the gate open each read
``correct`` false; the weights, moments and draws are the benchmark's own,
whatever the program's init writes; a traced step records every nerf.* span and both
counters; the roofline's bound counts the first layer's input gradient
only where the gate is open. On a card, the reference in TF32 (the
control) and on half of each step's pixels, and the corrections left at
zero, read past a limit at the cell's size.

``sizes.py`` holds the older cells' small sizes; this cell's is registered
in its ``TINY`` from here (``GARF_TINY``), which the directory's other
tests read once pytest has collected this module, so run them together:
``python -m pytest benchmark/tests``."""
import copy
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import control
from benchmark.lib import catalog, harness, spans, work
from benchmark.lib.readings import Readings
from benchmark.reference import garf as gref
from benchmark.tests import sizes
from conftest import ROOT

CELL = "garf_easyship.train"


def _tiny() -> dict:
    """4 views of 16x16, 64 rays requested (16 pixels a view), 8 samples
    per ray; the widths, the rates and the gate as the cell's."""
    barf = copy.deepcopy(catalog.config(ROOT, catalog.load(ROOT), "garf_easyship")["barf"])
    barf["nerf"].update(rand_rays=64, sample_intvs=8)
    barf["data"]["image_size"] = [16, 16]
    return {"config": {"barf": {"nerf": barf["nerf"], "data": barf["data"]},
                       "scene": {"views": 4, "gt_samples": 32, "render_rows": 16}},
            "mix": {"warm_steps": 3, "trace_steps": 2}}


GARF_TINY = _tiny()
sizes.TINY.setdefault(CELL, GARF_TINY)


def _run(trace=False, seed=2 ** 31 + 23):
    return harness.run_cell(ROOT, CELL, seed, 0.0, trace, "cpu", time.perf_counter(), GARF_TINY)


def test_the_configuration_is_easyship_as_it_loads():
    from myc_nerfs_tpu_torch.cli.train import config_to_train_config
    from myc_nerfs_tpu_torch.core.config import load_config

    bench = catalog.load(ROOT)
    cfg = catalog.config(ROOT, bench, "garf_easyship")
    assert cfg["family"] == "garf" and cfg["reduced"] == ["datadir"]
    loaded = load_config(str(ROOT / "configs/barf/Easyship.yaml"))
    assert cfg["barf"] == json.loads(json.dumps(loaded))
    assert cfg["assumed"]["H"] == cfg["assumed"]["W"] == 400 == loaded["data"]["image_size"][0]
    assert cfg["assumed"]["views"] == cfg["scene"]["views"] == 100
    assert cfg["assumed"]["global_step"] == cfg["stage"]["global_step"] == 100000
    tcfg = config_to_train_config(loaded)
    spec = gref.garf_spec(cfg["barf"])
    assert gref.layer_widths(spec) == [(3, 256), (256, 256), (256, 256), (259, 256),
                                       (256, 256), (256, 257), (259, 128), (128, 3)]
    assert gref.macs_per_sample(spec) == 363008
    assert (tcfg.rand_rays // 100, tcfg.sample_intvs, tcfg.start_pose_correct_iter) == (
        20, 128, 80000)
    assert catalog.cell(bench, CELL)["chips"] == 1


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_small_and_is_correct(trace):
    line = _run(trace)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line
    work_ = line["work"]
    assert (work_["views"], work_["rays_per_step"], work_["samples_per_step"]) == (4, 64, 512)
    assert work_["pose_gate_open"] is True
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap", "pose_gap"}
    if trace:
        # no device here: the GEMM roofline finds no kernel, the spans do
        assert {"pose_idle_ms_per_step.train", "mfu.train", "idle_share.train",
                "device_ms_per_step.train", "host_syncs_per_step.train"} <= set(line["metrics"])
        assert "nerf_gemm_roofline.train" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}


def _unchanged(monkeypatch):
    """The step runs its loss and backward; both Adams return no change and
    their state as it was."""
    from myc_nerfs_tpu_torch.train import nerf_trainer

    def adam_step(sched, betas, eps, grads, state):
        return [torch.zeros_like(g) for g in grads], state

    monkeypatch.setattr(nerf_trainer, "adam_step", adam_step)


def _half_batch(monkeypatch):
    """The loss is the mean over the first half of each step's pixels."""
    from myc_nerfs_tpu_torch.train import nerf_trainer

    mse = nerf_trainer.img2mse

    def half(x, y):
        n = x.shape[1] // 2
        return mse(x[:, :n], y[:, :n])

    monkeypatch.setattr(nerf_trainer, "img2mse", half)


def zero_corrections(monkeypatch):
    """The gate is open and the corrections' gradient and Adam run, but the
    corrections are left at zero after every step."""
    from myc_nerfs_tpu_torch.train import nerf_trainer

    make = nerf_trainer.make_train_step

    def make_zero(*args, **kwargs):
        step = make(*args, **kwargs)

        def zero_step(state, draws):
            new, metrics = step(state, draws)
            return new._replace(se3_refine=torch.zeros_like(new.se3_refine)), metrics

        return zero_step

    monkeypatch.setattr(nerf_trainer, "make_train_step", make_zero)


def test_the_state_and_the_draws_are_the_benchmarks_own(monkeypatch):
    """The weights, moments and draws both sides start from are made by the
    benchmark from the seed: an init of the program's that writes NaN leaves
    no trace in the state, which is barf's TF-Xavier within each layer's
    bound; the second moments are positive; the pixels are distinct."""
    import math

    from benchmark.families import garf as fam
    from myc_nerfs_tpu_torch.models import nerf_mlp

    monkeypatch.setattr(nerf_mlp, "_xavier_init_", lambda k, init, g: k.fill_(math.nan))
    config = copy.deepcopy(catalog.config(ROOT, catalog.load(ROOT), "garf_easyship"))
    harness.merge({"config": config}, {"config": GARF_TINY["config"]})
    b = fam.build(config, 2 ** 40 + 5, "cpu")
    made = fam.make_params(b.spec, 2 ** 40 + 5, "cpu")
    for n, leaf in zip(gref.leaf_names(b.spec), b.state.params.param_list()):
        assert torch.equal(leaf.detach(), made[n]) and torch.equal(b.init[n], made[n]), n
    for i, (fan_in, fan_out) in enumerate(gref.layer_widths(b.spec)):
        k = made[f"Dense_{i}.kernel"]
        gain = 1.0 if i == len(gref.layer_widths(b.spec)) - 1 else math.sqrt(2.0)
        if i == len(b.spec.widths_feat) - 1:
            assert float(k[:, 0].abs().max()) <= math.sqrt(6.0 / (fan_in + 1))
            k, fan_out = k[:, 1:], fan_out - 1
        bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
        assert 0.9 * bound < float(k.abs().max()) <= bound, i
        assert not made[f"Dense_{i}.bias"].any()
    assert all(bool((v > 0).all()) for v in b.nu.values())
    assert [v.shape for v in b.state.opt_state.nu] == [made[n].shape
                                                       for n in gref.leaf_names(b.spec)]
    assert not any(m.any() for m in b.state.opt_state.mu)
    V, H, W = b.images.shape[:3]
    d = fam.draw(b.tcfg, V, H, W, b.gen, "cpu")
    assert d.ray_idx.unique().numel() == d.ray_idx.numel() == b.tcfg.rand_rays // V
    line = _run()
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault,number", [(_unchanged, "change_gap"),
                                          (_half_batch, "loss_gap"),
                                          (zero_corrections, "pose_gap")])
def test_a_broken_path_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    line = _run()
    assert line["correct"] is False, line["checks"]
    assert line["checks"][number]["value"] > line["checks"][number]["limit"], line["checks"]


def test_a_traced_step_records_the_nerf_spans_and_counters():
    """Two train steps under a CPU profiler: nerf.pose, .field, .composite,
    .backward and .update once each inside nerf.step; nerf.samples the
    rays x samples of both forwards and nerf.pose_refined 2 (the gate open),
    traced; without a profiler the samples add to the host total only."""
    from benchmark.families import garf as fam
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt
    from myc_nerfs_tpu_torch.utils import profiling

    config = copy.deepcopy(catalog.config(ROOT, catalog.load(ROOT), "garf_easyship"))
    harness.merge({"config": config}, {"config": GARF_TINY["config"]})
    b = fam.build(config, 11, "cpu")
    V, H, W = b.images.shape[:3]
    step = nt.make_train_step(b.tcfg, b.images, b.poses, b.intr)
    inner = ("nerf.pose", "nerf.field", "nerf.composite", "nerf.backward", "nerf.update")
    assert set(inner) | {"nerf.step"} <= set(profiling.SPANS)
    assert {"nerf.samples", "nerf.pose_refined"} <= set(profiling.COUNTERS)
    profiling.reset()
    state = b.state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, nt.draw_step(b.tcfg, V, H, W, b.gen, "cpu"))
    inside = {}
    for e in prof.events():
        if e.name not in profiling.SPANS:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in profiling.SPANS:
            parent = parent.cpu_parent
        key = (e.name, parent.name if parent is not None else None)
        inside[key] = inside.get(key, 0) + 1
    assert inside == {("nerf.step", None): 2, **{(n, "nerf.step"): 2 for n in inner}}, inside
    n = V * (b.tcfg.rand_rays // V) * b.tcfg.sample_intvs
    traced = profiling.counts(traced=True)
    assert traced["nerf.samples"] == 2 * n and traced["nerf.pose_refined"] == 2
    step(state, nt.draw_step(b.tcfg, V, H, W, b.gen, "cpu"))
    assert profiling.counts()["nerf.samples"] == 3 * n
    assert profiling.counts(traced=True) == traced
    profiling.reset()


def test_the_nerf_gemm_bound_counts_the_first_dgrad_only_with_the_gate_open(monkeypatch):
    """The bound reads the samples and the open steps from the program's
    traced counters; the first layer's input gradient is in the steps
    whose gate is open alone; without the counters it reads None."""
    spec = gref.garf_spec(catalog.config(ROOT, catalog.load(ROOT), "garf_easyship")["barf"])
    bound = catalog.bound(ROOT, "nerf_gemm")
    r = Readings(ROOT, "train", None, 4, spec, "f32", {"nerf_gemm": [spec]})
    monkeypatch.setattr(spans, "traced_counts", lambda: {})
    assert bound(r) is None
    rows = 256000
    counts = {"nerf.samples": 4 * rows, "nerf.pose_refined": 4}
    monkeypatch.setattr(spans, "traced_counts", lambda: counts)
    opened = bound(r)
    counts["nerf.pose_refined"] = 0
    closed = bound(r)
    # a step: 185.9 GFLOP forward, 371.7 with the gate closed backward (every
    # dW, every dgrad but the first layer's), at 495/3 TFLOP/s; the bytes of
    # the points, the view directions, the outputs and the weights move in
    # microseconds
    macs = gref.macs_per_sample(spec)
    first = 3 * 256
    per_step = 3.0 * 2.0 * rows * (3 * macs - first) / work.FLOPS["tf32"]
    assert closed == pytest.approx(4 * per_step, rel=1e-3)
    assert opened - closed == pytest.approx(4 * 3.0 * 2.0 * rows * first / work.FLOPS["tf32"],
                                            rel=1e-3)
    assert 3.37e-3 < closed / 4 < 3.39e-3
    assert bound(Readings(ROOT, "train", None, 4, spec, "f32", {})) is None


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["control", "half"])
def test_the_control_and_the_half_batch_are_not_correct(cuda_device, side):
    limits = catalog.limits(ROOT, CELL)
    readings = control.control_side(CELL, 9001, cuda_device, side=side)
    assert any(readings[k] > limits[k] for k in limits), (readings, limits)


@pytest.mark.cuda
def test_corrections_left_at_zero_fail_pose_gap(cuda_device, monkeypatch):
    zero_corrections(monkeypatch)
    readings = control.program_side(CELL, 9002, cuda_device)
    assert readings["pose_gap"] > catalog.limits(ROOT, CELL)["pose_gap"], readings
