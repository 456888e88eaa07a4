"""Runs one cell of the benchmark of myc_nerfs_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), device, breakdown (traced runs) and
checks (each number the correctness check compared, with its limit). The
same numbers close standard error. Exits non-zero, printing no result,
without the devices, or if JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # one host thread for CPU ops: the host path is one Python thread, and
    # idle worker threads only compete with it for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from benchmark.lib import catalog, harness

    cell = catalog.cell(catalog.load(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules that may not be loaded were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
