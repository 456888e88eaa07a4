"""What a traced run hands the per-layer metric readers, and the helpers
they share.

A reader (``benchmark/metrics/<metric>.py``) defines ``read(r)`` and returns
a number, or None where its layer left nothing to read in this run. The
kernels of a layer are found by name: every line of every file under
``benchmark/kernels/<layer>/`` is a substring of a kernel name that
implements the layer, and ``benchmark/bounds/<layer>.py`` gives the least
time of the work the run handed the layer.
"""
from __future__ import annotations

import gc
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import catalog


def sync() -> None:
    """Wait for the device where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def settle() -> None:
    """At the end of set-up: wait for the device, collect, and move what
    set-up made out of the collector's way (gc.freeze), so that no full
    collection over it lands in the window."""
    sync()
    gc.collect()
    gc.freeze()


def kernel_patterns(root: Path, layer: str) -> List[str]:
    """The kernel-name patterns of a layer: the non-empty, non-comment
    lines of benchmark/kernels/<layer>/*.txt."""
    out = []
    for path in sorted((Path(root) / "benchmark" / "kernels" / layer).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


class Readings:
    """A traced run: ``trace`` (lib/profile.Trace) over ``units`` steps or
    frames of mode ``mode`` ("train" or "render"). ``spec`` is the cell's
    reference spec, ``dtype`` its field's ("bf16", "f32"), and ``calls`` the
    family's records of the traced calls into the program, by kind
    (``encode``, ``mlp``, ``factor_sampling``); the bound of a layer
    (``benchmark/bounds/<layer>.py``) reads them. Other attributes a cell
    may set: ``mfu_pct`` (model FLOPs over the untraced window's wall time
    and the peak, %), ``grid_update_s`` (seconds of each synchronised
    occupancy update in the traced steps)."""

    mfu_pct: Optional[float] = None
    grid_update_s: Optional[List[float]] = None

    def __init__(self, root, mode: str, trace, units: int, spec=None, dtype: str = "f32",
                 calls: Optional[Dict[str, list]] = None):
        self.root, self.mode, self.trace, self.units = Path(root), mode, trace, units
        self.spec, self.dtype, self.calls = spec, dtype, calls or {}

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.wall_s)

    def device_ms_per_unit(self) -> float:
        return 1e3 * self.trace.busy_s() / self.units

    def roofline_pct(self, layer: str) -> Optional[float]:
        """The layer's least time (``bound_s(r)`` of benchmark/bounds/<layer>.py)
        over the device time of its kernels (%); None where the run handed
        the layer no work or no kernel of it ran."""
        spent = self.trace.seconds_matching(kernel_patterns(self.root, layer))
        if spent <= 0.0:
            return None
        bound = catalog.bound(self.root, layer)(self)
        return None if bound is None else 100.0 * bound / spent
