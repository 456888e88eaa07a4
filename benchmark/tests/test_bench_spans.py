"""The readers of the program's spans and counters (benchmark/lib/spans.py
and the metrics built on it) on hand-built traces: a gap under ngp.batch,
a synchronise inside a program span and one outside, nested spans for self
time, and a program without spans or counters."""
import pytest

from benchmark.lib import catalog, spans
from benchmark.lib.profile import Trace
from benchmark.lib.readings import Readings
from conftest import ROOT


def _trace(device, host, wall_us=1000.0):
    t = Trace()
    t.device, t.host, t.wall_s = device, host, wall_us / 1e6
    return t


def _read(metric, trace, mode="train", units=2):
    return catalog.reader(ROOT, metric)(Readings(ROOT, mode, trace, units))


# one train block of two steps: the harness's span around it, the batch made
# on the host, its copies, two steps with their phases, the batch
# adaptation's read, and a harness synchronise after it
STEP_HOST = [
    ("bench.train_block", 0.0, 1000.0),
    ("ngp.batch", 10.0, 210.0),
    ("aten::stack", 150.0, 200.0),
    ("ngp.h2d", 220.0, 300.0),
    ("cudaMemcpyAsync", 230.0, 240.0),
    ("cudaStreamSynchronize", 240.0, 290.0),
    ("ngp.step", 300.0, 600.0),
    ("ngp.march", 310.0, 400.0),
    ("ngp.field", 400.0, 450.0),
    ("ngp.update", 500.0, 590.0),
    ("ngp.step", 600.0, 900.0),
    ("ngp.update", 800.0, 830.0),
    ("ngp.adapt_batch", 900.0, 950.0),
    ("cudaStreamSynchronize", 910.0, 940.0),
    ("cudaDeviceSynchronize", 960.0, 990.0),
]
# busy until 20 us, then idle through the batch (20-250: middle 135, under
# ngp.batch), busy 250-260, idle 260-320 (middle 290, ngp.h2d), busy to 905,
# idle 905-995 (middle 950: under no program span), busy to 1000
STEP_DEVICE = [("k", 0.0, 20.0), ("copy", 250.0, 260.0), ("k", 320.0, 905.0),
               ("k", 995.0, 1000.0)]


def test_program_spans_are_the_declared_names_in_order():
    found = spans.program_spans(_trace(STEP_DEVICE, STEP_HOST))
    assert [e[0] for e in found] == ["ngp.batch", "ngp.h2d", "ngp.step", "ngp.march",
                                     "ngp.field", "ngp.update", "ngp.step", "ngp.update",
                                     "ngp.adapt_batch"]
    assert spans.program_spans(_trace([], [("outer", 0.0, 9.0), ("inner", 0.0, 5.0)]),
                               ["inner", "outer"]) == [("outer", 0.0, 9.0),
                                                       ("inner", 0.0, 5.0)]


def test_innermost_span_at_a_time():
    found = spans.program_spans(_trace(STEP_DEVICE, STEP_HOST))
    assert spans.innermost(found, [5.0, 100.0, 350.0, 420.0, 460.0, 550.0, 700.0, 810.0,
                                   955.0]) == [None, "ngp.batch", "ngp.march", "ngp.field",
                                               "ngp.step", "ngp.update", "ngp.step",
                                               "ngp.update", None]


def test_self_time_leaves_out_the_nested_spans():
    found = spans.program_spans(_trace(STEP_DEVICE, STEP_HOST))
    self_s = spans.self_seconds(found)
    # the first step: 300 us less march 90, field 50, update 90; the second 300 - 30
    assert self_s["ngp.step"] == pytest.approx((70.0 + 270.0) / 1e6)
    assert self_s["ngp.march"] == pytest.approx(90e-6)
    assert self_s["ngp.update"] == pytest.approx(120e-6)
    assert spans.seconds(found[0]) == pytest.approx(200e-6)


def test_blocking_calls_inside_program_spans_only():
    t = _trace(STEP_DEVICE, STEP_HOST)
    assert spans.blocking_calls(t, spans.program_spans(t)) == [
        ("cudaStreamSynchronize", "ngp.h2d"), ("cudaStreamSynchronize", "ngp.adapt_batch")]
    # the harness's cudaDeviceSynchronize at 960-990 lies under no program span
    assert _read("host_syncs_per_step.train", t) == pytest.approx(1.0)
    assert _read("host_syncs_per_frame.render", t, "render", 1) == pytest.approx(2.0)


def test_idle_device_time_by_innermost_program_span():
    t = _trace(STEP_DEVICE, STEP_HOST)
    idle = spans.idle_by_span(t, spans.program_spans(t))
    assert idle == pytest.approx({"ngp.batch": 230e-6, "ngp.h2d": 60e-6, None: 90e-6})
    # (230 + 60) us over 2 steps
    assert _read("data_idle_ms_per_step.train", t) == pytest.approx(0.145)


def test_update_and_chunk_host_ms():
    t = _trace(STEP_DEVICE, STEP_HOST)
    assert _read("update_host_ms.train", t) == pytest.approx((0.09 + 0.03) / 2)
    tf = _trace([], [("tensorf.step", 0.0, 900.0), ("tensorf.update", 700.0, 850.0)])
    assert _read("update_host_ms.train", tf, units=1) == pytest.approx(0.15)
    frame = _trace([], [("ngp.frame", 0.0, 10000.0)]
                   + [("ngp.chunk", 100.0 + 2000.0 * i, 1600.0 + 2000.0 * i) for i in range(4)]
                   + [("ngp.march", 200.0, 300.0)])
    assert _read("chunk_host_ms.render", frame, "render", 1) == pytest.approx(1.5)


def test_march_valid_pct_reads_the_traced_counters(monkeypatch):
    monkeypatch.setattr(spans, "traced_counts",
                        lambda: {"ngp.march.slots": 4096 * 64, "ngp.march.valid": 65536})
    t = _trace([], [])
    assert _read("march_valid_pct.train", t) == pytest.approx(25.0)
    assert _read("march_valid_pct.render", t, "render") == pytest.approx(25.0)
    assert _read("march_valid_pct.train", t, "render") is None
    monkeypatch.setattr(spans, "traced_counts",
                        lambda: {"ngp.march.slots": 0, "ngp.march.valid": 0})
    assert _read("march_valid_pct.train", t) is None


NEW = ("host_syncs_per_step.train", "host_syncs_per_frame.render", "march_valid_pct.train",
       "march_valid_pct.render", "update_host_ms.train", "data_idle_ms_per_step.train",
       "chunk_host_ms.render")


@pytest.mark.parametrize("metric", NEW)
def test_readers_return_none_for_a_program_without_spans(metric, monkeypatch):
    """A program that declares no spans and keeps no registry (the one
    before them) leaves every new metric out of the line, and raises
    nothing; so does a trace that holds only the harness's spans."""
    mode = metric.rsplit(".", 1)[1]
    monkeypatch.setattr(spans, "traced_counts", lambda: {})
    harness_only = _trace(STEP_DEVICE, [("bench.train_block", 0.0, 1000.0),
                                        ("cudaStreamSynchronize", 10.0, 20.0)])
    assert _read(metric, harness_only, mode) is None
    monkeypatch.setattr(spans, "declared", lambda: frozenset())
    assert _read(metric, _trace(STEP_DEVICE, [e for e in STEP_HOST
                                              if not e[0].startswith("ngp.")]), mode) is None


@pytest.mark.parametrize("metric", NEW)
def test_new_metrics_are_declared_with_their_cells(metric):
    bench = catalog.load(ROOT)
    entry = next(m for m in bench["per_layer"] if m["name"] == metric)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert entry["workloads"] and all(w in e2e[entry["moves"]]["workloads"]
                                      for w in entry["workloads"])
    assert (ROOT / "benchmark" / "metrics" / f"{metric}.py").exists()
