"""The port's spans and counters (myc_nerfs_tpu_torch/utils/profiling.py):
under a CPU torch.profiler an NGP train block, a whole-image render and a
TensoRF step emit their declared spans, nested as the program nests them,
at function scope (no user annotation, so nothing on a device timeline);
with no profiler a span is one shared null context and the traced counters
stay still; the march's counters and the kernels' launch counts."""
import contextlib
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from myc_nerfs_tpu_torch.cli import run_net
from myc_nerfs_tpu_torch.cli import tensorf_train as tcli
from myc_nerfs_tpu_torch.core.config import init_cfg, load_config
from myc_nerfs_tpu_torch.utils import profiling

torch.set_num_threads(1)

PACKAGE = Path(profiling.__file__).resolve().parents[1]
REPO = PACKAGE.parent
POSE = torch.tensor([[1.0, 0.0, 0.0, 0.5], [0.0, 1.0, 0.0, 0.5], [0.0, 0.0, 1.0, -0.5]])
INTR = torch.tensor([[20.0, 0.0, 6.0], [0.0, 20.0, 6.0], [0.0, 0.0, 1.0]])


def _ngp():
    cfg = load_config(str(REPO / "configs/ngp/demo_synthetic.py"))
    cfg.update(synthetic_size=12, synthetic_views=4, n_rays_per_batch=128,
               n_grid_uniform=1024, n_grid_nonuniform=1024)
    init_cfg(cfg)
    data, _, _ = run_net.load_data(cfg, "cpu")
    trainer, tcfg = run_net.build_trainer(cfg, torch.Generator().manual_seed(0), device="cpu")
    return trainer, tcfg, data


def _tensorf():
    a = tcli.parse_txt_config(str(REPO / "configs/tensorf/demo_synthetic.txt"))
    a.update(synthetic_size=8, synthetic_views=4, batch_size=128, nSamples=32,
             update_AlphaMask_list=[2], upsamp_list=[3])
    model_cfg, train_cfg = tcli.build_configs(a)
    rays, rgbs, aabb, _ = tcli.load_rays(a, "cpu")
    return tcli.build_family_trainer(a, model_cfg, train_cfg, aabb, device="cpu"), rays, rgbs


def _profiled(fn):
    """(fn's result, the program's span events) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in profiling.SPANS]


def _nesting(events):
    """{(span, nearest enclosing program span or None): count}."""
    out = {}
    for e in events:
        parent = e.cpu_parent
        while parent is not None and parent.name not in profiling.SPANS:
            parent = parent.cpu_parent
        key = (e.name, parent.name if parent is not None else None)
        out[key] = out.get(key, 0) + 1
    return out


@pytest.fixture(scope="module")
def ngp_block():
    """One train_loop block (16 steps, one grid update) under a profiler,
    the counters reset before it."""
    trainer, tcfg, data = _ngp()
    profiling.reset()
    history, events = _profiled(lambda: run_net.train_loop(
        trainer, tcfg, data, tcfg.update_den_freq, torch.Generator().manual_seed(1),
        log=lambda *a: None))
    return {"trainer": trainer, "tcfg": tcfg, "metrics": history[0], "events": events,
            "traced": profiling.counts(traced=True), "totals": profiling.counts()}


@pytest.fixture(scope="module")
def ngp_frame(ngp_block):
    _, events = _profiled(lambda: ngp_block["trainer"].render_image(POSE, INTR, 12, 12,
                                                                     chunk=64))
    return events


@pytest.fixture(scope="module")
def tensorf_steps():
    trainer, rays, rgbs = _tensorf()
    _, events = _profiled(lambda: trainer.train(rays, rgbs, n_iters=3))
    return events


def test_ngp_train_block_spans_nest_as_the_program(ngp_block):
    S = ngp_block["tcfg"].update_den_freq
    assert _nesting(ngp_block["events"]) == {
        ("ngp.grid_update", None): 1, ("ngp.batch", None): 1, ("ngp.h2d", None): 1,
        ("ngp.step", None): S, ("ngp.march", "ngp.step"): S, ("ngp.field", "ngp.step"): S,
        ("ngp.composite", "ngp.step"): S, ("ngp.loss", "ngp.step"): S,
        ("ngp.backward", "ngp.step"): S, ("ngp.update", "ngp.step"): S,
        ("ngp.adapt_batch", None): 1}


def test_ngp_frame_spans_nest_as_the_program(ngp_frame):
    chunks = -(-12 * 12 // 64)
    assert _nesting(ngp_frame) == {
        ("ngp.frame", None): 1, ("ngp.chunk", "ngp.frame"): chunks,
        ("ngp.march", "ngp.chunk"): chunks, ("ngp.field", "ngp.chunk"): chunks,
        ("ngp.composite", "ngp.chunk"): chunks}


def test_tensorf_step_spans_nest_as_the_program(tensorf_steps):
    """Three steps through train: the second ends with the alpha-mask
    event, the third with the upsample."""
    inner = ("tensorf.sample", "tensorf.density", "tensorf.shade", "tensorf.composite",
             "tensorf.regularizers", "tensorf.backward", "tensorf.update")
    want = {("tensorf.batch", None): 3, ("tensorf.step", None): 3, ("tensorf.events", None): 3}
    want.update({(n, "tensorf.step"): 3 for n in inner})
    assert _nesting(tensorf_steps) == want


@pytest.mark.parametrize("case", ["ngp_block", "ngp_frame", "tensorf_steps"])
def test_spans_are_function_scope_not_user_annotations(case, request):
    """A user annotation (record_function) is drawn on the device timeline
    too; the program's spans are recorded at function scope, as aten ops."""
    got = request.getfixturevalue(case)
    events = got["events"] if isinstance(got, dict) else got
    assert events and all(not e.is_user_annotation and e.scope == 0 for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)


def _literal_names(call: str):
    pattern = re.compile(call + r"\s*\"([^\"]+)\"")
    for path in sorted(PACKAGE.rglob("*.py")):
        for name in pattern.findall(path.read_text()):
            yield path.relative_to(PACKAGE.parent), name


def test_every_span_name_in_the_package_is_declared():
    used = list(_literal_names(r"\bspan\("))
    assert used and all(name in profiling.SPANS for _, name in used), used
    # and every declared span is placed somewhere
    assert set(profiling.SPANS) == {name for _, name in used}


def test_every_counter_name_in_the_package_is_declared():
    # count("name", n), or a kernel launch's counter="name" (ops/cuda/_build.py)
    used = list(_literal_names(r"\bcount\(")) + list(_literal_names(r"\bcounter="))
    assert used and all(name in profiling.COUNTERS for _, name in used), used
    assert set(profiling.COUNTERS) == {name for _, name in used}


def test_undeclared_names_are_refused():
    with pytest.raises(AssertionError):
        profiling.span("ngp.undeclared")
    with pytest.raises(AssertionError):
        profiling.count("launch.undeclared", 1)


def test_without_a_profiler_a_span_is_the_shared_null_context():
    a, b = profiling.span("ngp.step"), profiling.span("tensorf.shade")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:  # reentrant
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(profiling.span("ngp.step"), contextlib.nullcontext)


def test_without_a_profiler_the_traced_counters_stay_still(ngp_block):
    trainer, tcfg = ngp_block["trainer"], ngp_block["tcfg"]
    before_traced, before = profiling.counts(traced=True), profiling.counts()
    m = trainer.train_block(*(torch.rand(2, 32, 3) for _ in range(3)),
                            generator=torch.Generator().manual_seed(2))
    trainer.render_image(POSE, INTR, 12, 12, chunk=64)
    assert profiling.counts(traced=True) == before_traced
    # host ints still add to the totals: the train block's and the frame's slots
    K, Kr = trainer.rcfg.n_compact, trainer.rcfg.n_samples
    assert profiling.counts()["ngp.march.slots"] == (before["ngp.march.slots"]
                                                     + 2 * 32 * K + 3 * 64 * Kr)
    # a device scalar is counted only while a profiler records
    assert profiling.counts()["ngp.march.valid"] == before["ngp.march.valid"] == 0
    assert int(m["n_samples"].sum()) > 0


def test_traced_march_counters_are_the_steps_samples(ngp_block):
    """Traced ngp.march.valid is the sum of the steps' n_samples (the
    compositor's own count), ngp.march.slots the rays times n_compact."""
    m, traced = ngp_block["metrics"], ngp_block["traced"]
    S = ngp_block["tcfg"].update_den_freq
    assert traced["ngp.march.valid"] == int(m["n_samples"].sum()) > 0
    assert traced["ngp.march.slots"] == S * 128 * ngp_block["trainer"].rcfg.n_compact
    assert ngp_block["totals"]["ngp.march.slots"] == traced["ngp.march.slots"]


def test_counts_reads_every_declared_counter_and_reset_zeroes_them():
    profiling.reset()
    assert profiling.counts() == profiling.counts(traced=True) == dict.fromkeys(
        profiling.COUNTERS, 0)
    profiling.count("launch.fused_mlp", 2)
    profiling.count("ngp.march.valid", torch.tensor(5))
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("launch.fused_mlp", 3)
        profiling.count("ngp.march.valid", torch.tensor(7))
        profiling.count("ngp.march.valid", torch.tensor([4]))
    assert profiling.counts()["launch.fused_mlp"] == 5
    assert profiling.counts(traced=True)["launch.fused_mlp"] == 3
    assert profiling.counts()["ngp.march.valid"] == 0
    assert profiling.counts(traced=True)["ngp.march.valid"] == 11
    profiling.reset()
    assert set(profiling.counts(traced=True).values()) == set(profiling.counts().values()) == {0}


def test_the_cpu_kernel_paths_count_no_launches(ngp_block):
    """On the CPU every kernel wrapper runs its plain version: a whole NGP
    block and frame leave every launch counter at 0."""
    launches = {k: v for k, v in ngp_block["totals"].items() if k.startswith("launch.")}
    assert launches and set(launches.values()) == {0}


@pytest.mark.cuda
def test_kernel_launches_are_counted_in_the_registry():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    x = torch.randn(256, 32, device="cuda", dtype=torch.bfloat16)
    ws = [torch.randn(32, 64, device="cuda", dtype=torch.bfloat16) / 8,
          torch.randn(64, 16, device="cuda", dtype=torch.bfloat16) / 8]
    profiling.reset()
    with torch.no_grad():
        fm.fused_mlp(x, ws)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with profiling.span("ngp.field"):
                fm.fused_mlp(x, ws)
    torch.cuda.synchronize()
    assert profiling.counts()["launch.fused_mlp"] == 2
    assert profiling.counts(traced=True)["launch.fused_mlp"] == 1
    # the span is a host event only: nothing of it on the device's timeline
    assert not [e for e in prof.events() if e.name in profiling.SPANS
                and e.device_type == torch.autograd.DeviceType.CUDA]
