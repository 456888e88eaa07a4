"""Multi-GPU programs at full width (counterpart of
scripts/compile_real_multichip.py): four legs on a mesh of ``--ranks``
processes, each printing one JSON line.

    python -m myc_nerfs_tpu_torch.cli.multichip [--ranks 8] [--data D --model M]
        [--steps 16] [--device cuda] [--small]

- ngp: the L16F2 2^19 brick3 grid with its hashed groups split over
  "model" (spmd.GroupTPModel; 4 groups, so model in {1, 2, 4}), rays over
  "data", a block of ``--steps`` steps at 64 rays per step per data shard,
  n_coarse 128, n_samples 32, every cell occupied;
- render: the trained model renders one step's rays (n_coarse 128, K 18,
  early_stop_eps 4.5e-3) with the rays over "data" and the tables still
  split (spmd.multichip_ngp_render);
- garf: GARF (8 x 256) with pose refinement from step 0 on 8 images of
  64^2, 2048 rays x 128 samples per step, 2 steps, images over every rank
  (ranks x 1);
- tensorf: TensoRF VM-split at 300^3 voxels, comps 16 / 48, batch 1024,
  2 steps, rays over every rank (ranks x 1).

The mesh of the ngp and render legs is ``--data`` x ``--model`` (default:
model 2 when the rank count is even, as __graft_entry__.dryrun_multichip
takes it). One rank per card on NCCL when there are as many cards, else
ranks share the cards under gloo (mesh.choose_backend; the first line
says which). Weights come from seeded generators on the card; rays,
targets and every draw from seeded generators in this process, handed to
every rank, which slices its shard. ``--small`` cuts every width for a
CPU smoke run (``--device cpu``). Exits with an error without a card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import List, Optional

import numpy as np
import torch

from ..parallel import mesh as mesh_lib
from ..parallel import ranks, spmd

RAYS_PER_SHARD = 64   # rays per step per data shard of the ngp leg
TIMEOUT_S = 900.0     # each collective and the whole launch


def ngp_spec(steps: int, rays_per_shard: int, data: int, small: bool, seed: int = 0) -> dict:
    """The ngp (and render) leg's inputs: configs and the global batch."""
    from ..models.ngp import HashGridConfig, NGPModelConfig
    from ..render.ngp_render import NGPRenderConfig
    from ..train.ngp_trainer import NGPTrainConfig

    grid = (HashGridConfig(n_levels=7, log2_hashmap_size=14, desired_resolution=512.0)
            if small else HashGridConfig())
    B = rays_per_shard * data
    ro, rd, tg = spmd.ring_rays(steps * B, seed + 1)
    xi = torch.rand((steps * B, 1), generator=torch.Generator().manual_seed(seed + 7))
    shape = lambda t: t.reshape(steps, B, -1).numpy()  # noqa: E731
    return dict(rays_o=shape(ro), rays_d=shape(rd), target=shape(tg), xi=shape(xi),
                model_cfg=NGPModelConfig(grid=grid, grid_impl="brick3"),
                rcfg=NGPRenderConfig(aabb_scale=1, n_coarse=32 if small else 128,
                                     n_samples=8 if small else 32),
                tcfg=NGPTrainConfig(n_rays_per_batch=B, target_batch_size=1 << 11,
                                    n_grid_uniform=1 << 12, n_grid_nonuniform=0,
                                    update_den_freq=16),
                seed=seed, table_mode="groups")


def render_spec(spec: dict, small: bool):
    """The render leg: the first step's rays at the shipped profile."""
    from ..render.ngp_render import NGPRenderConfig

    rcfg = NGPRenderConfig(aabb_scale=1, n_coarse=32 if small else 128,
                           n_samples=8 if small else 18, early_stop_eps=4.5e-3)
    return (rcfg, spec["rays_o"][0], spec["rays_d"][0])


def garf_spec(ranks_n: int, small: bool, steps: int = 2, seed: int = 0) -> dict:
    from ..data.synthetic import make_scene
    from ..train import nerf_trainer as nt

    n_images = ranks_n if small else 8
    size, rays, samples = (10, n_images * 16, 8) if small else (64, 2048, 128)
    cfg = nt.NeRFTrainConfig(model="garf", refine_pose=True, camera_noise=0.05,
                             start_pose_correct_iter=0, rand_rays=rays,
                             sample_intvs=samples, max_iter=64,
                             **(dict(widths_feat=(32,) * 4, skip=(2,)) if small else {}))
    scene = make_scene(n_views=n_images, H=size, W=size)
    gen = torch.Generator().manual_seed(seed + 7)
    draws = [nt.draw_step(cfg, n_images, size, size, gen) for _ in range(steps)]
    return dict(cfg=cfg, images=scene.images.numpy(), poses=scene.poses.numpy(),
                intr=scene.intr.numpy(), draws=ranks.draws_to_numpy(draws), seed=seed)


def tensorf_spec(small: bool, steps: int = 2, seed: int = 0) -> dict:
    from ..models import tensorf as tf_m
    from ..train import tensorf_trainer as tt

    batch = 64 if small else 1024
    if small:
        mcfg, tcfg, aabb = spmd.tensorf_block_configs(batch, steps)
    else:
        mcfg = tf_m.TensoRFConfig(density_n_comp=(16, 16, 16), app_n_comp=(48, 48, 48),
                                  near_far=(0.5, 6.0), step_ratio=0.5,
                                  shading_mode="MLP_Fea", view_pe=2, fea_pe=2)
        tcfg = tt.TensoRFTrainConfig(n_iters=steps, batch_size=batch,
                                     n_voxel_init=27_000_000, n_voxel_final=27_000_000,
                                     upsamp_list=(), update_alphamask_list=())
        aabb = None
    rays, rgbs, jitter = spmd.tensorf_block_batch(batch, steps, seed)
    return dict(rays=rays.numpy(), rgbs=rgbs.numpy(), draws=jitter.numpy(), mcfg=mcfg,
                tcfg=tcfg, aabb=aabb, seed=seed, render=rays[0].numpy())


def mesh_split(n_ranks: int, data: Optional[int], model: Optional[int]):
    """(data, model) of the ngp leg: as given, else model 2 when the rank
    count is even."""
    if model is None:
        model = n_ranks // data if data else (2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1)
    data = data or n_ranks // model
    if data * model != n_ranks:
        raise SystemExit(f"--data {data} x --model {model} != --ranks {n_ranks}")
    return data, model


def build_legs(args) -> list:
    """[(name, kind, model, spec)] for ranks.run_legs."""
    data, model = mesh_split(args.ranks, args.data, args.model)
    spec = ngp_spec(args.steps, RAYS_PER_SHARD, data, args.small)
    spec["render"] = render_spec(spec, args.small)
    return [("ngp", "ngp", model, spec),
            ("garf", "nerf", 1, garf_spec(args.ranks, args.small)),
            ("tensorf", "tensorf", 1, tensorf_spec(args.small))]


def finite(values) -> bool:
    return all(math.isfinite(v) for v in np.asarray(values, np.float64).reshape(-1))


def leg_lines(results: list, legs: list, backend_line: str) -> List[dict]:
    """One JSON-ready dict per leg (and for the render) from every rank's
    results: the mesh, the backend, finite flags, per-step losses of rank 0
    and the seconds of the slowest rank."""
    lines = []
    for name, kind, model, spec in legs:
        rs = [r[name] for r in results]
        r0 = rs[0]
        key = "mse" if kind == "tensorf" else "loss"
        line = {"event": f"multichip_{name}", "mesh": r0["shape"], "backend": r0["backend"],
                "cards": backend_line, key: r0[key], "finite": finite([r[key] for r in rs]),
                "train_s": max(r["train_s"] for r in rs),
                "step_s_median": float(np.median([np.median(r["step_s"][1:] or r["step_s"])
                                                  for r in rs]))}
        if kind == "ngp":
            line["launches"] = [r["launches"] for r in rs]
        lines.append(line)
        if kind == "ngp" and "render" in r0:
            rr = [r["render"] for r in rs]
            lines.append({"event": "multichip_render", "mesh": r0["shape"],
                          "backend": r0["backend"], "rays": int(rr[0]["rgb"].shape[0]),
                          "n_samples": rr[0]["n_samples"],
                          "rgb_finite": finite([x["rgb"] for x in rr]),
                          "render_s": max(x["s"] for x in rr),
                          "launches": [x["launches"] for x in rr]})
    return lines


def main(argv: Optional[list] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--data", type=int, default=None)
    p.add_argument("--model", type=int, default=None)
    p.add_argument("--steps", type=int, default=16, help="steps of the ngp block")
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="tiny widths (a CPU smoke run)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is false; pass "
                         "--device cpu to run on the CPU")
    ranks.prebuild(args.device)
    legs = build_legs(args)
    _, _, backend_line = mesh_lib.choose_backend(args.device, args.ranks)
    results = mesh_lib.spawn(ranks.run_legs, args.ranks, args.device, legs,
                             model=legs[0][2], timeout=TIMEOUT_S)
    lines = leg_lines(results, legs, backend_line)
    for line in lines:
        print(json.dumps(line), flush=True)
    if not all(line.get("finite", line.get("rgb_finite")) for line in lines):
        sys.exit("multichip: a leg's loss or render is not finite")
    return lines


if __name__ == "__main__":
    main()
