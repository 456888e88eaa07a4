"""The readings a cell's limits are set from, on a CUDA device.

    python3 benchmark/control.py --workload <cell> --side program|control|half --seeds 1 2 3

``--side program`` runs the cell's set-up and the check of a run for each
seed, with the shortest window (the family's ``shortest`` mix, one block of
steps or one frame): the lower readings. The other sides are the family's
``control(ctx, side)``: ``control`` puts the reference, computed in the
nearest precision below the configuration's, in the program's place and
compares it with the reference (the upper readings; the NGP cells round
the encode's output and the MLPs to float8 e4m3, the TensoRF cell runs its
matrix products in TF32); ``half`` (train cells) puts the reference on half
of each batch, the mean taken over the rest, in the program's place: the
reading of that fault. One JSON line per seed. The benchmark's runs do not
run this; its tests (benchmark/tests/test_bench_control.py) run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_side(cell: str, seed: int, device: str, overrides=None) -> dict:
    from benchmark.lib import catalog, harness

    _, ctx = harness.context(ROOT, cell, seed, 0.0, False, device, 0.0, overrides)
    short = {"mix": catalog.family(ctx.config["family"]).shortest(ctx.mix)}
    harness.merge(short, overrides)
    line = harness.run_cell(ROOT, cell, seed, 0.0, False, device, time.perf_counter(), short)
    return {k: c["value"] for k, c in line["checks"].items()}


def control_side(cell: str, seed: int, device: str, overrides=None, side: str = "control") -> dict:
    from benchmark.lib import catalog, harness

    _, ctx = harness.context(ROOT, cell, seed, 0.0, False, device, time.perf_counter(),
                             overrides)
    return catalog.family(ctx.config["family"]).control(ctx, side)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control", "half"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t = time.perf_counter()
        if args.side == "program":
            out = program_side(args.workload, seed, "cuda")
        else:
            out = control_side(args.workload, seed, "cuda", side=args.side)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
