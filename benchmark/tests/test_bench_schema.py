"""The result line's schema, BENCHMARK.json against the contract it is
written to, the refusal without a card, and the check for JAX."""
import json
import math
import subprocess
import sys
import time

import pytest

from benchmark.lib import catalog, harness
from benchmark.tests.sizes import TINY
from conftest import ROOT

BENCH = catalog.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_schema(name, trace):
    line = harness.run_cell(ROOT, name, 2 ** 31 + 5, 0.0, trace, "cpu", time.perf_counter(),
                            TINY[name])
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = (catalog.per_layer if trace else catalog.end_to_end)(BENCH, name)
    units = {m["name"]: m["unit"] for m in want}
    assert set(line["metrics"]) <= set(units)
    for k, m in line["metrics"].items():
        assert m["unit"] == units[k] and _number(m["value"])
    if not trace:
        assert set(line["metrics"]) == set(units)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert _number(c["value"]) and _number(c["limit"])


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", CELLS):
            assert w in CELLS and w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith((".train", ".render")) and ("roofline" in m["name"]
                                                           or "mfu" in m["name"]):
            assert m["unit"] == "%"
        assert m["layer"] and "\n" not in m["layer"] and len(m["layer"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert any(m["name"] != "setup_s" for m in catalog.end_to_end(BENCH, w["name"]))
        assert catalog.per_layer(BENCH, w["name"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ngp_car.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert proc.stdout.strip() == "" and "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("myc_nerfs_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "myc_nerfs_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "myc_nerfs_tpu"]


def test_configurations_are_the_sources_as_run():
    """The Car and Coffee files hold the repository's configs as they load."""
    from myc_nerfs_tpu_torch.cli.tensorf_train import parse_txt_config
    from myc_nerfs_tpu_torch.core.config import load_config

    car = json.loads((ROOT / "benchmark/configs/ngp_car.json").read_text())["run_net"]
    assert car == json.loads(json.dumps(dict(load_config(str(ROOT / "configs/ngp/Car.py")))))
    coffee = json.loads((ROOT / "benchmark/configs/tensorf_coffee.json").read_text())["tensorf"]
    assert coffee == json.loads(json.dumps(parse_txt_config(
        str(ROOT / "configs/tensorf/Coffee.txt"))))
