"""One run of one cell: set-up and window by the cell's family, the
reference check, and the result line."""
from __future__ import annotations

import gc
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import catalog
from .profile import top

# top-level module names that may not be loaded in a run: JAX and the JAX
# package (the port, myc_nerfs_tpu_torch, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "myc_nerfs_tpu")


class Ctx:
    """What a family's ``run(ctx)`` is given."""

    def __init__(self, root: Path, cell: dict, config: dict, mix: dict, limits: Dict[str, float],
                 seed: int, seconds: float, trace: bool, device: str, t0: float):
        self.root, self.cell, self.config, self.mix = root, cell, config, mix
        self.limits, self.seed, self.seconds, self.trace = limits, seed, seconds, trace
        self.device, self.t0 = torch.device(device), t0

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0

    def free(self) -> None:
        """Release what the program held before the reference runs."""
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def merge(parts: Dict[str, dict], overrides: Optional[dict]) -> None:
    """Merge ``overrides`` ({"config": {...}, "mix": {...}, ...}) into the
    dicts of ``parts`` by part name, one level deep."""
    for part, value in (overrides or {}).items():
        target = parts[part]
        for k, v in value.items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k].update(v)
            else:
                target[k] = v


def context(root: Path, name: str, seed: int, seconds: float, trace: bool, device: str,
            t0: float, overrides: Optional[dict] = None) -> Tuple[dict, Ctx]:
    """(BENCHMARK.json, the run's Ctx) of cell ``name``, its files found by
    name; ``overrides`` as ``merge``'s (the tests run cells small)."""
    bench = catalog.load(root)
    cell = catalog.cell(bench, name)
    config = catalog.config(root, bench, cell["config"])
    mix = catalog.mix(root, cell["traffic"])
    limits = catalog.limits(root, name)
    merge({"config": config, "mix": mix, "limits": limits}, overrides)
    seed = int(seed) % (1 << 63)
    return bench, Ctx(Path(root), cell, config, mix, limits, seed, seconds, trace, device, t0)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, overrides: Optional[dict] = None) -> dict:
    """Run cell ``name`` once and return its result line (a dict)."""
    bench, ctx = context(root, name, seed, seconds, trace, device, t0, overrides)
    out = catalog.family(ctx.config["family"]).run(ctx)
    return result_line(bench, ctx.cell, ctx, out)


def result_line(bench: dict, cell: dict, ctx: Ctx, out: dict) -> dict:
    """The last line's object: correct, attempted, failed, metrics, device,
    (traced) breakdown, and last the numbers compared with their limits."""
    metrics: Dict[str, dict] = {}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {}
    if not ctx.trace:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in catalog.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        r = out["readings"]
        for m in catalog.per_layer(bench, cell["name"]):
            v = catalog.reader(ctx.root, m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = r.trace.busy_s()
        device["window_s"] = r.trace.wall_s
        line["breakdown"] = {"device_ops": top(r.trace.by_name()),
                             "idle_gaps": top(r.trace.idle_gaps())}
    checks: List[Tuple[str, float, float]] = out["checks"]
    correct = out["failed"] == 0 and all(v <= lim for _, v, lim in checks)
    # a number that is not finite fails its check, and is written as text (JSON has no NaN)
    checks = [(k, v if math.isfinite(v) else str(v), lim) for k, v, lim in checks]
    return {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device, **line, "work": out.get("work", {}),
            "checks": {k: {"value": v, "limit": lim} for k, v, lim in checks}}
