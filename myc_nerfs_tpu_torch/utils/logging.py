"""Console logging, an ETA timer and metric writers (counterpart of
myc_nerfs_tpu/utils/logging.py; barf util.py:55-92), as far as the port's
CLIs use them.

Plain-text metric files (``<name>.txt``, one "step value" line per call)
and TensorBoard scalars through tensorboardX where it is importable.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional


def _c(text, color):
    codes = dict(red=31, green=32, yellow=33, blue=34, magenta=35, cyan=36)
    if not sys.stdout.isatty():
        return str(text)
    return f"\033[{codes[color]}m{text}\033[0m"


class Log:
    """Coloured console logger (util.py:55-83)."""

    def title(self, msg):
        print(_c(msg, "yellow"))

    def info(self, msg):
        print(_c(msg, "green"))

    def warning(self, msg):
        print(_c(f"WARNING: {msg}", "magenta"))


log = Log()


class ETATimer:
    """EMA-smoothed time per iteration (util.py:85-92, base.py:96-115)."""

    def __init__(self, ema: float = 0.99):
        self.ema = ema
        self.it_mean: Optional[float] = None
        self._last = time.time()

    def update(self, it: int, max_it: int) -> float:
        """Seconds left at iteration ``it`` of ``max_it``."""
        now = time.time()
        dt = now - self._last
        self._last = now
        self.it_mean = dt if self.it_mean is None else \
            self.ema * self.it_mean + (1 - self.ema) * dt
        return self.it_mean * (max_it - it)


class MetricWriter:
    """Append-only metric text files (psnr.txt / quant.txt style) and
    TensorBoard scalars where tensorboardX is importable."""

    def __init__(self, out_dir: str, use_tb: bool = False):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.tb = None
        if use_tb:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                log.warning("tensorboardX is not installed: scalars go to text files only")
            else:
                self.tb = SummaryWriter(out_dir)

    def scalar(self, name: str, value: float, step: int) -> None:
        with open(os.path.join(self.out_dir, f"{name.replace('/', '_')}.txt"), "a") as f:
            f.write(f"{step} {value}\n")
        if self.tb is not None:
            self.tb.add_scalar(name, value, step)

    def quant_line(self, filename: str, *values) -> None:
        """A quant.txt / quant_pose.txt row (nerf.py:153-157, garf.py:224-228)."""
        with open(os.path.join(self.out_dir, filename), "a") as f:
            f.write(" ".join(str(v) for v in values) + "\n")
