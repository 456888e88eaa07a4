"""Finds everything a cell needs by the names in BENCHMARK.json.

- a cell: an entry of ``workloads``;
- its configuration: the JSON file the ``configs`` entry names; its
  ``family`` key names the module under ``benchmark/families/`` that runs it;
- its traffic mix: ``benchmark/traffic/<traffic>.json``; its ``mode`` key
  names the family's loop (``train``, ``render``);
- its limits: ``benchmark/checks/<cell>.json``, each number the correctness
  check compares and its limit;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, with ``read(r)``;
- a layer's kernels: ``benchmark/kernels/<layer>/*.txt``;
- a layer's least time, for its roofline: ``benchmark/bounds/<layer>.py``,
  with ``bound_s(r)``.

Adding a cell, a mix, a configuration of an existing family, a metric, a
roofline of a new layer or a kernel name is a new file and new entries,
with no edit to harness code.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(root: Path, name: str) -> dict:
    return json.loads((Path(root) / "benchmark" / "traffic" / f"{name}.json").read_text())


def limits(root: Path, cell_name: str) -> Dict[str, float]:
    return json.loads((Path(root) / "benchmark" / "checks" / f"{cell_name}.json").read_text())


def family(name: str):
    return importlib.import_module(f"benchmark.families.{name}")


def reports(metric: dict, cell_name: str) -> bool:
    """Whether a metric entry is reported in a cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["per_layer"] if reports(m, cell_name)]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, metric: str) -> Callable:
    """``read`` of benchmark/metrics/<metric>.py (a name may hold dots)."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    return _load(path, f"benchmark_metric_{metric}").read


def bound(root: Path, layer: str) -> Callable:
    """``bound_s`` of benchmark/bounds/<layer>.py."""
    path = Path(root) / "benchmark" / "bounds" / f"{layer}.py"
    return _load(path, f"benchmark_bound_{layer}").bound_s
