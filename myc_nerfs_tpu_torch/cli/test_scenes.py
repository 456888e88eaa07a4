"""The five-scene inference driver (counterpart of
myc_nerfs_tpu/cli/test_scenes.py; the reference's umbrella test.py:1-38).

    python -m myc_nerfs_tpu_torch.cli.test_scenes [--synthetic]
        [--data_root data] [--result_dir result] [--configs_root configs]
        [--refine_dir data_refine/Easyship] [--device cuda]

Renders each scene's test set into ``result/<scene>/``: Coffee, Scar and
Scarf through the TensoRF stack (cli/tensorf_train --render_only 1), Car
and Easyship through Instant-NGP (cli/run_net --task test; Easyship's
images are copied next to its GARF-refined poses in ``--refine_dir``
first). A scene without data is skipped with a notice. ``--synthetic``
runs the driver on the built-in synthetic scene instead: TensoRF's
demo_synthetic.txt trained 50 steps and rendered, then NGP's
demo_synthetic.py trained 50 steps and tested (from its checkpoint: the
JAX driver's test pass leaves load_ckpt off and renders the untrained
field). The rendered images (.png, and .npy where PIL is missing) are
copied, depth maps excepted. ``--device`` is passed through.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional

from ..utils.logging import log

TENSORF_SCENES = ["Coffee", "Scar", "Scarf"]
NGP_SCENES = ["Car", "Easyship"]


def _copy_images(src_dir: str, dst_dir: str) -> int:
    """The rendered images of src_dir (.png, and .npy for a run without
    PIL), depth maps excepted, into dst_dir; returns how many."""
    if not os.path.isdir(src_dir):
        return 0
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        if name.endswith((".png", ".npy")) and "depth" not in name:
            shutil.copy2(os.path.join(src_dir, name), os.path.join(dst_dir, name))
            n += 1
    return n


def _with_ckpt(cfg: str, out_dir: str) -> str:
    """A config in out_dir that inherits ``cfg`` and restores its
    checkpoint (load_ckpt = True)."""
    path = os.path.join(out_dir, "test_" + os.path.basename(cfg))
    with open(path, "w") as f:
        f.write(f"_base_ = {os.path.abspath(cfg)!r}\nload_ckpt = True\n")
    return path


def synthetic(args) -> str:
    from . import run_net, tensorf_train

    dev = ["--device", args.device]
    log.title("synthetic umbrella run (no scene data present)")
    cfg = os.path.join(args.configs_root, "tensorf", "demo_synthetic.txt")
    tensorf_train.main(["--config", cfg, "--n_iters", "50"] + dev)
    out = tensorf_train.main(["--config", cfg, "--render_only", "1"] + dev)
    _copy_images(os.path.join(out, "imgs_test_all"), os.path.join(args.result_dir, "demo_tensorf"))
    ngp_cfg = os.path.join(args.configs_root, "ngp", "demo_synthetic.py")
    out = run_net.main(["--config-file", ngp_cfg, "--task", "train", "--steps", "50"] + dev)
    out = run_net.main(["--config-file", _with_ckpt(ngp_cfg, args.result_dir), "--task", "test"]
                       + dev)
    _copy_images(os.path.join(out, "test"), os.path.join(args.result_dir, "demo_ngp"))
    log.info("synthetic umbrella run complete")
    return args.result_dir


def main(argv: Optional[list] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_root", default="data")
    ap.add_argument("--result_dir", default="result")
    ap.add_argument("--configs_root", default="configs")
    ap.add_argument("--refine_dir", default=os.path.join("data_refine", "Easyship"))
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu to run on the CPU)")
    args = ap.parse_args(argv)
    os.makedirs(args.result_dir, exist_ok=True)
    if args.synthetic:
        return synthetic(args)
    dev = ["--device", args.device]

    for scene in TENSORF_SCENES:
        if not os.path.isdir(os.path.join(args.data_root, scene)):
            log.warning(f"skip {scene}: no data at {args.data_root}/{scene}")
            continue
        from . import tensorf_train

        log.title(f"render_test {scene}")
        cfg = os.path.join(args.configs_root, "tensorf", f"{scene}.txt")
        out = tensorf_train.main(["--config", cfg, "--render_only", "1"] + dev)
        _copy_images(os.path.join(out, "imgs_test_all"), os.path.join(args.result_dir, scene))

    # Easyship: the raw images beside the refined poses (test.py:25-28)
    if os.path.isdir(os.path.join(args.data_root, "Easyship")) and \
            os.path.isdir(args.refine_dir):
        for split in ("train", "val", "test"):
            src = os.path.join(args.data_root, "Easyship", split)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(args.refine_dir, split), dirs_exist_ok=True)

    for scene in NGP_SCENES:
        root = args.refine_dir if scene == "Easyship" else os.path.join(args.data_root, scene)
        if not os.path.isdir(root):
            log.warning(f"skip {scene}: no data at {root}")
            continue
        from . import run_net

        log.title(f"NGP test {scene}")
        cfg = os.path.join(args.configs_root, "ngp", f"{scene}.py")
        out = run_net.main(["--config-file", cfg, "--task", "test"] + dev)
        _copy_images(os.path.join(out, "test"), os.path.join(args.result_dir, scene))
    return args.result_dir


if __name__ == "__main__":
    main()
