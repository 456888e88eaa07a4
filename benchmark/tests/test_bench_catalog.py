"""Discovery by name: every cell, configuration, mix, limit, metric and
kernel list that BENCHMARK.json names is found in a file of its own, and a
new cell, mix or metric is added by new files and entries alone."""
import json
import re
import shutil
import time

import pytest

from benchmark.lib import catalog, harness
from benchmark.lib.profile import Trace
from benchmark.lib.readings import Readings, kernel_patterns
from benchmark.tests.sizes import TINY
from conftest import ROOT

BENCH = catalog.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = catalog.cell(BENCH, name)
    config = catalog.config(ROOT, BENCH, cell["config"])
    family = catalog.family(config["family"])
    mix = catalog.mix(ROOT, cell["traffic"])
    limits = catalog.limits(ROOT, name)
    assert callable(family.run)
    assert mix["mode"] in ("train", "render")
    assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_is_found_by_name(metric):
    assert callable(catalog.reader(ROOT, metric))


@pytest.mark.parametrize("layer", sorted({m["name"].split("_roofline")[0]
                                          for m in BENCH["per_layer"]
                                          if "_roofline" in m["name"]}))
def test_roofline_layers_name_their_kernels(layer):
    assert kernel_patterns(ROOT, layer)


def test_reports_follow_workloads_lists():
    per_cell = {c: {m["name"] for m in catalog.per_layer(BENCH, c)} for c in CELLS}
    assert "grid_encode_roofline.train" in per_cell["ngp_car.train"]
    assert "grid_encode_roofline.train" not in per_cell["ngp_car.render"]
    assert {m["name"] for m in catalog.end_to_end(BENCH, "ngp_car.render")} == {
        "render_rays_per_s", "frame_ms_p90", "setup_s"}


def test_a_new_cell_mix_and_metric_need_no_harness_edit(tmp_path):
    """A copy of the benchmark gains a cell (a new mix file, a limits file,
    an entry), a metric (a reader file, an entry), a kernel name (a file)
    and the roofline of a new layer (a bound file, a kernel list); the
    harness runs the new cell and reports the new metric, and the roofline
    reads the new layer's bound over its kernels' time."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic" / "train_steady.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "train_short.json").write_text(
        json.dumps(dict(mix, warm_steps=16)))
    (tmp_path / "benchmark" / "checks" / "ngp_car.train_short.json").write_text(
        (ROOT / "benchmark" / "checks" / "ngp_car.train.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "traced_steps.train.py").write_text(
        "def read(r):\n    return float(r.units) if r.mode == 'train' else None\n")
    (tmp_path / "benchmark" / "kernels" / "grid_encode" / "later.txt").write_text(
        "a_later_encode_kernel\n")
    bench["workloads"].append({"name": "ngp_car.train_short", "config": "ngp_car",
                               "traffic": "train_short", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("ngp_car.train_short")
    bench["per_layer"].append({"name": "traced_steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "train step",
                               "moves": "train_rays_per_s",
                               "workloads": ["ngp_car.train_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "bounds" / "later_layer.py").write_text(
        "def bound_s(r):\n    return 2e-6 if r.calls.get('later') else None\n")
    (tmp_path / "benchmark" / "kernels" / "later_layer").mkdir()
    (tmp_path / "benchmark" / "kernels" / "later_layer" / "k.txt").write_text("later_k\n")
    assert "a_later_encode_kernel" in kernel_patterns(tmp_path, "grid_encode")
    t = Trace()
    t.wall_s, t.device = 10e-6, [("later_k_fwd", 0.0, 4.0), ("other", 4.0, 8.0)]
    assert Readings(tmp_path, "train", t, 1, calls={"later": [1]}).roofline_pct(
        "later_layer") == pytest.approx(50.0)
    assert Readings(tmp_path, "train", t, 1).roofline_pct("later_layer") is None
    line = harness.run_cell(tmp_path, "ngp_car.train_short", 3, 0.0, True, "cpu",
                            time.perf_counter(), TINY["ngp_car.train"])
    assert line["metrics"]["traced_steps.train"] == {"value": 16.0, "unit": "steps"}
    line = harness.run_cell(tmp_path, "ngp_car.train_short", 3, 0.0, False, "cpu",
                            time.perf_counter(), TINY["ngp_car.train"])
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}


def test_names_and_units_keep_to_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(name.match(n) for n in names)
    assert all(unit.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
