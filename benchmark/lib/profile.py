"""The reduction of a torch.profiler window to what the per-layer metrics
read: the union of the device's busy intervals, device time by name, and
the idle gaps with what the host was doing in each.

A frozen copy of the port's utils/profiling.py::device_profile reduction
(union of the device events' intervals, time by name), extended with the
idle gaps.
"""
from __future__ import annotations

import contextlib
import heapq
import time
from typing import Dict, List, Tuple

import torch


SPAN = "bench."  # the prefix of the harness's own spans (record_function)


def span(name: str, on: bool = True):
    """A host span named bench.<name> while ``on``, else nothing."""
    return torch.profiler.record_function(SPAN + name) if on else contextlib.nullcontext()


class Trace:
    """A profiled window: device events (name, start us, end us), host
    events (name, start us, end us) and the window's host wall seconds."""

    def __init__(self):
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.wall_s = 0.0
        self._prof = None

    def start(self) -> None:
        """Start profiling (CPU and CUDA activity) from a synchronised point."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Synchronise, stop, and keep the window's events."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        for e in self._prof.events():
            item = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the harness's spans (bench.*) show on the device's timeline
                # too, as annotations: they are no device work
                if not e.name.startswith(SPAN):
                    self.device.append(item)
            else:
                self.host.append(item)
        self._prof = None

    # -- reductions ---------------------------------------------------------

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, sorted (us)."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def by_name(self) -> Dict[str, float]:
        """Device seconds summed by event name."""
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def seconds_matching(self, patterns: List[str]) -> float:
        """Device seconds of the events whose name holds any pattern."""
        return sum(s for n, s in self.by_name().items() if any(p in n for p in patterns))

    def idle_gaps(self) -> Dict[str, float]:
        """Idle device seconds inside the window, by the innermost host
        event running at the middle of each gap ("host" where none is)."""
        busy = self.busy_intervals()
        if not busy:
            return {}
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        hosts = sorted(self.host, key=lambda e: e[1])
        out: Dict[str, float] = {}
        active: List[Tuple[float, float, str]] = []  # max-heap on start
        i = 0
        for a, b in gaps:
            at = 0.5 * (a + b)
            while i < len(hosts) and hosts[i][1] <= at:
                name, s, e = hosts[i]
                heapq.heappush(active, (-s, e, name))
                i += 1
            while active and active[0][1] <= at:
                heapq.heappop(active)
            # events nest: the running one that started last is the innermost
            name = active[0][2] if active else "host"
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
