"""Test-pose transfer CLI (counterpart of myc_nerfs_tpu/cli/compare_pose.py;
the reference's compare_pose.py:9-85).

Carries the refined val poses' deltas to the unseen test poses and writes
<refine_root>/<exp>/transforms_test.json. Host-side (numpy and torch on the
CPU): it handles a few dozen 4x4 matrices.

    python -m myc_nerfs_tpu_torch.cli.compare_pose --exp Easyship \\
        [--method trans|sim3] [--data_root data] [--refine_root data_refine]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

from ..evaluation.pose_export import compare_pose
from ..utils.logging import log


def main(argv: Optional[list] = None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp", default="Easyship")
    parser.add_argument("--method", default="trans", choices=["trans", "sim3"])
    parser.add_argument("--data_root", default="data")
    parser.add_argument("--refine_root", default="data_refine")
    parser.add_argument("--val_old", default=None,
                        help="override: original val transforms json")
    parser.add_argument("--val_new", default=None,
                        help="override: refined val transforms json")
    parser.add_argument("--test_old", default=None)
    parser.add_argument("--test_new", default=None)
    args = parser.parse_args(argv)

    val_old = args.val_old or os.path.join(args.data_root, args.exp, "transforms_val.json")
    val_new = args.val_new or os.path.join(args.refine_root, args.exp, "transforms_val.json")
    test_old = args.test_old or os.path.join(args.data_root, args.exp, "transforms_test.json")
    test_new = args.test_new or os.path.join(args.refine_root, args.exp,
                                             "transforms_test.json")
    os.makedirs(os.path.dirname(test_new) or ".", exist_ok=True)
    compare_pose(val_old, val_new, test_old, test_new, method=args.method)
    log.info(f"wrote {test_new} ({args.method})")
    return test_new


if __name__ == "__main__":
    main()
