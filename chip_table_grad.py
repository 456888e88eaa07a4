"""chip_smoke phase 8's end-to-end table-gradient check, looked at closely.

Trains the phase's NGP config (configs/ngp/Car.py on the synthetic scene,
chip_smoke's TRAIN_* cut) from each seed given and, after each of its 16
blocks, takes two fresh batches. For each it prints, per table, the
gradient's |a-b|/|b| between the kernel path and the plain path, the
per-batch bound (chip_smoke.table_e2e_bounds), the actual difference of
the two paths' dx propagated through the plain encode backward, how much
of the worst table's difference its ten largest elements carry, and how
many dx elements sit more than one bf16 ulp apart. The last line sums up
the worst reading against its bound. Needs an NVIDIA GPU:

    python3 chip_table_grad.py [--seeds 0 1]
"""
import argparse
import subprocess

import numpy as np
import torch

import chip_smoke as cs


def check(trainer, batch, tag: str) -> tuple:
    from myc_nerfs_tpu_torch.ops import brick_grid as bg

    model = trainer.model
    n = len(model.tables)
    kern, k = cs.train_gradients(trainer, batch, True, True)
    plain, p = cs.train_gradients(trainer, batch, False, False)
    rel = [cs.rel(a, b) for a, b in zip(kern[:n], plain[:n])]
    bound = cs.table_e2e_bounds(trainer, k, p, plain[:n])
    dx = cs.dx_ulps(k, p)
    diff = (k["g"].float() - p["g"].float()).to(torch.bfloat16)
    with torch.no_grad():
        moved = bg.paired_encode_backward_reference(
            [t.detach() for t in model.tables], k["pos"], diff, model.cfg.grid,
            model.levels, model.groups, model.compute_dtype)
    prop = [float(m.norm()) / max(float(b.float().norm()), 1e-30)
            for m, b in zip(moved, plain[:n])]
    worst = int(np.argmax(rel))
    d = (kern[worst].float() - plain[worst].float()).reshape(-1)
    top = torch.topk(d.abs(), 10)
    share = float(top.values.norm()) / max(float(d.norm()), 1e-30)
    at = plain[worst].float().reshape(-1)[top.indices[:3]].tolist()
    print(f"table_grad {tag}: rays {batch[0].shape[0]} |a-b|/|b| "
          + " ".join(f"{v:.3e}" for v in rel) + " | bound "
          + " ".join(f"{v:.3e}" for v in bound) + " | dx difference through the encode "
          + " ".join(f"{v:.3e}" for v in prop)
          + f" | worst table {worst}: its 10 largest differences carry {share:.3f} of the "
          f"norm, the 3 largest {[f'{v:.3e}' for v in top.values[:3].tolist()]} where the "
          f"plain gradient is {[f'{v:.3e}' for v in at]} | dx elements more than one ulp "
          f"apart {dx['over']} of {dx['n']}, at most {dx['max']:.1f} ulps", flush=True)
    return rel, bound, dx


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = p.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.phase_build()
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.data.blender import RayBatcher

    cfg = load_config("configs/ngp/Car.py")
    cfg.update(synthetic=True, synthetic_views=cs.TRAIN_VIEWS, synthetic_size=cs.TRAIN_SIZE)
    data, _, _ = run_net.load_data(cfg)
    out = []
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xi_gen = torch.Generator(device="cuda").manual_seed(2)
        trainer, tcfg = run_net.build_trainer(cfg, gen, device="cuda")
        train_block = trainer.train_block

        def checked_block(*a, **k):
            m = train_block(*a, **k)
            for b in range(cs.SPLIT_BATCHES):
                img_ids, pix_ids = RayBatcher(data.n_images, data.n_pixels,
                                              trainer.n_rays_per_batch,
                                              seed=1000 * len(out) + b + 7 * seed).next()
                rays_o, rays_d = (torch.from_numpy(x).cuda()
                                  for x in data.rays_for_pixels(img_ids, pix_ids))
                target = torch.from_numpy(data.pixel_values(img_ids, pix_ids)).cuda()
                xi = torch.rand((rays_o.shape[0], 1), device="cuda", generator=xi_gen)
                out.append(check(trainer, (rays_o, rays_d, target, torch.ones_like(target), xi),
                                 f"seed {seed} step {trainer.state.step} batch {b}"))
            return m

        trainer.train_block = checked_block
        run_net.train_loop(trainer, tcfg, data, cs.TRAIN_STEPS, gen, log=lambda msg: None)
    rel = np.array([r for r, _, _ in out])
    ratio = rel / np.array([b for _, b, _ in out])
    i, t = np.unravel_index(ratio.argmax(), ratio.shape)
    j, u = np.unravel_index(rel.argmax(), rel.shape)
    print(f"table_grad summary: {len(out)} checks; |a-b|/|b| max {rel[j, u]:.3e} (check {j}, "
          f"table {u}, reading / bound {ratio[j, u]:.3f}); reading / bound max "
          f"{ratio[i, t]:.3f} (check {i}, table {t}); dx elements more than one ulp apart "
          f"per check {min(d['over'] for _, _, d in out)} to "
          f"{max(d['over'] for _, _, d in out)}, at most "
          f"{max(d['max'] for _, _, d in out):.1f} ulps [{smi}]", flush=True)


if __name__ == "__main__":
    main()
