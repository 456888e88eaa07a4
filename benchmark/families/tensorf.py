"""TensoRF cells: a tensorf-myc configuration trained at one stage through
``TensoRFTrainer.train`` (its permutation sampler and ``train_step``), at
global steps past every event, on views of a synthetic object that the
benchmark renders from the seed.

Set-up builds the trainer with ``cli/tensorf_train.build_family_trainer``,
puts it at the stage the configuration names (the benchmark's own factor
grids at that resolution, the density shaped to the object; the stage
geometry), runs the program's own alpha-mask update over it, and trains
``warm_steps`` steps in the one call to ``train`` that also carries the
window. The harness hooks the trainer's ``loss``, ``train_step`` and
``events`` to count the work and to end the window after the first step
past ``--seconds``.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Dict

import numpy as np
import torch

from ..lib import scenes, work
from ..lib.checks import first_ids, kept, train_gaps
from ..lib.profile import Trace, span
from ..lib.readings import Readings, settle, sync
from ..reference import tensorf as ref


class _WindowClosed(Exception):
    """Raised after a step to end TensoRFTrainer.train once the window closes."""


def make_params(spec: ref.TensoRFSpec, obj: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The stage's parameters from the seed, on the device: factor grids
    N(0, 0.1) with the first density component of each plane-line pair
    shaped to the object's ellipsoid (``amplitude`` x a soft indicator of
    its projection, times one of its extent), the basis U(+-1/sqrt(in)),
    the MLP kernels truncated normal (variance 1/fan_in), biases zero."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ref.leaf_shapes(spec)
    grids = [n for n in shapes if ref.is_spatial(n)]
    z = torch.randn(sum(math.prod(shapes[n]) for n in grids), generator=g, device=device)
    out, a = {}, 0
    for n in grids:
        k = math.prod(shapes[n])
        out[n] = (0.1 * z[a:a + k]).reshape(shapes[n])
        a += k
    radii, amp, sharp = obj["radii"], obj["amplitude"], obj["sharpness"]

    def axis(size: int, r: float) -> torch.Tensor:
        return torch.linspace(-1.0, 1.0, size, device=device) / r

    for i, (m0, m1) in enumerate(ref.MAT_MODE):
        P = out[f"density_plane.{i}"]
        v, u = torch.meshgrid(axis(P.shape[1], radii[m1]), axis(P.shape[2], radii[m0]),
                              indexing="ij")
        P[0] = amp * torch.sigmoid((1.0 - torch.sqrt(u * u + v * v)) * sharp)
        L = out[f"density_line.{i}"]
        L[0] = torch.sigmoid((1.0 - axis(L.shape[1], radii[ref.VEC_MODE[i]]).abs()) * sharp)
    n_in = shapes["basis_mat"][0]
    out["basis_mat"] = (torch.rand(shapes["basis_mat"], generator=g, device=device) * 2 - 1) \
        / math.sqrt(n_in)
    kernels = [n for n in shapes if n.endswith("kernel")]
    t = torch.empty(sum(math.prod(shapes[n]) for n in kernels), device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    a = 0
    for n in kernels:
        k = math.prod(shapes[n])
        out[n] = t[a:a + k].reshape(shapes[n]) * (math.sqrt(1.0 / shapes[n][0])
                                                   / 0.87962566103423978)
        a += k
        out[n.replace("kernel", "bias")] = torch.zeros(shapes[n][1], device=device)
    return out


def make_rays(cfg: dict, seed: int, device):
    """(ray store [views * H * W, 6] of origins and unit directions, targets
    [views * H * W, 3]): the object's ellipsoid rendered over white from
    orbit cameras around the box, the orbit's phase drawn from the seed."""
    s, obj = cfg["scene"], cfg["object"]
    aabb = np.asarray(cfg["tensorf"]["bbox"], np.float64).reshape(2, 3)
    center = (aabb[0] + aabb[1]) / 2
    half = (aabb[1] - aabb[0]) / 2
    field = scenes.ellipsoid_field(center.tolist(), (half * np.asarray(obj["radii"])).tolist())
    H, W, focal = s["H"], s["W"], s["focal_factor"] * s["W"]
    phase = float(np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi))
    per = s["views"] // len(s["rings"])
    rays, rgbs = [], []
    for i, (r, e) in enumerate(s["rings"]):
        for c in scenes.orbit(per, r, e, phase + 0.45 * i, center.tolist()).to(device):
            rgbs.append(scenes.render(field, c, H, W, focal, tuple(s["depth_range"]),
                                      s["gt_samples"]).reshape(-1, 3))
            o, d = scenes.pixel_rays(c, H, W, focal)
            rays.append(torch.cat([o, d / torch.linalg.norm(d, dim=-1, keepdim=True)], -1))
    return torch.cat(rays), torch.cat(rgbs)


def build(config: dict, seed: int, device):
    """(trainer, spec, initial parameters by name, ray store, targets)."""
    from myc_nerfs_tpu_torch.cli.tensorf_train import build_configs, build_family_trainer
    from myc_nerfs_tpu_torch.models import tensorf as tf

    a = copy.deepcopy(config["tensorf"])
    model_cfg, train_cfg = build_configs(a)
    spec = ref.tensorf_spec(config)
    aabb = np.asarray(a["bbox"], np.float32).reshape(2, 3)
    trainer = build_family_trainer(a, model_cfg, train_cfg, aabb,
                                   torch.Generator(device=device).manual_seed(0), device)
    init = make_params(spec, config["object"], seed, device)
    params = dict(trainer.params)
    for key in ("app_line", "app_plane", "density_line", "density_plane"):
        params[key] = [tf._leaf(init[f"{key}.{i}"].clone()) for i in range(3)]
    params["basis_mat"] = tf._leaf(init["basis_mat"].clone())
    with torch.no_grad():
        for name, p in params["mlp"].named_parameters():
            p.copy_(init[f"mlp.{name}"])
    trainer.params = params
    trainer.geom = tf.compute_stage_geom(model_cfg, aabb, spec.grid, train_cfg.n_samples_cap)
    trainer.voxel_schedule = []
    reso = tuple(min(g, train_cfg.alpha_mask_reso_cap) for g in spec.grid)
    trainer.buffers, _ = tf.update_alpha_mask(model_cfg, trainer.geom, trainer.params,
                                              trainer.buffers, reso)
    trainer.set_step(config["stage"]["global_step"])
    trainer._rebuild(lr_scale=1.0)
    if (trainer.geom.n_samples, tuple(trainer.geom.grid_size)) != (spec.n_samples, spec.grid):
        raise RuntimeError(f"stage {trainer.geom} is not the configuration's {spec}")
    sync()
    t = time.perf_counter()
    rays, rgbs = make_rays(config, seed, device)
    sync()
    trainer.scene_s = time.perf_counter() - t
    return trainer, spec, init, rays, rgbs


def field_flops(spec: ref.TensoRFSpec):
    """Forward FLOPs per gated sample (density) and per shaded sample
    (appearance): per component the bilinear plane (8), the linear line
    (4), their product and the sum (2); the basis and the MLP products."""
    C = spec.feature_c
    dens = 14.0 * sum(spec.density_comp)
    app = (14.0 * sum(spec.app_comp) + 2.0 * sum(spec.app_comp) * spec.app_dim
           + work.mlp_flops([ref.mlp_in(spec), C, C, 3], 1))
    return dens, app


def run(ctx) -> dict:
    mix, device = ctx.mix, ctx.device
    trainer, spec, init, rays, rgbs = build(ctx.config, ctx.seed, device)
    first = trainer.global_step
    rec = {"phase": "warm", "n": 0, "steps": 0, "batches": [], "valid": [],
           "shaded": [], "finite": [], "traced": [], "traced_steps": 0}
    early: Dict[str, list] = {}

    orig_loss = trainer.loss

    def loss(rays_b, rgbs_b, draws, params=None, step=None):
        total, mse, out = orig_loss(rays_b, rgbs_b, draws, params, step)
        if len(rec["batches"]) < 3:
            rec["batches"].append((rays_b.detach().clone(), rgbs_b.detach().clone(),
                                   draws.detach().clone()))
            early.setdefault("loss", []).append(total.detach().clone())
        if rec["phase"] == "window":
            rec["valid"].append(out.extras["valid"].sum())
            rec["shaded"].append(out.extras["app_mask"].sum())
        elif rec["phase"] == "trace":
            rec["traced"].append((rays_b.detach(), out.extras["valid"].detach(),
                                  out.extras["app_mask"].detach(), out.z_vals.detach()))
        return total, mse, out

    orig_step = trainer.train_step

    def train_step(rays_b, rgbs_b, draws):
        with span("train_step", rec["phase"] == "trace"):
            out = orig_step(rays_b, rgbs_b, draws)
        if rec["phase"] == "window":
            rec["finite"].append(torch.isfinite(out["mse"]))
        done = trainer.global_step - first
        b1 = ref.BETAS[0]
        if done == 1:
            early["grad"] = [torch.linalg.norm(m / (1.0 - b1))
                             for m in trainer.opt_spatial.mu + trainer.opt_net.mu]
        elif done == 3:
            from myc_nerfs_tpu_torch.models import tensorf as tf

            spatial, net = tf.group_leaves(trainer.params)
            names = [n for n in ref.leaf_shapes(spec) if ref.is_spatial(n)] + \
                [n for n in ref.leaf_shapes(spec) if not ref.is_spatial(n)]
            early["change"] = [torch.linalg.norm(t.detach() - init[n])
                               for t, n in zip(spatial + net, names)]
        return out

    def events(step, all_rays):
        if rec["phase"] == "window":
            rec["steps"] += 1
        elif rec["phase"] == "trace":
            rec["traced_steps"] += 1
        rec["n"] += 1
        phase = rec["phase"]
        if phase == "warm" and rec["n"] >= mix["warm_steps"]:
            settle()
            rec["setup_end"] = time.perf_counter()
            if ctx.trace:
                rec["phase"] = "trace"
                rec["trace_end"] = rec["n"] + mix["trace_steps"]
                rec["tr"] = Trace()
                rec["tr"].start()
            else:
                rec["phase"], rec["t0"] = "window", time.perf_counter()
        elif phase == "trace" and rec["n"] >= rec["trace_end"]:
            rec["tr"].stop()
            rec["phase"], rec["t0"] = "window", time.perf_counter()
        elif phase == "window" and time.perf_counter() - rec["t0"] >= ctx.seconds:
            sync()
            rec["t1"] = time.perf_counter()
            raise _WindowClosed
        return None

    trainer.loss, trainer.train_step, trainer.events = loss, train_step, events
    scene_s, t_built = trainer.scene_s, time.perf_counter()
    try:
        trainer.train(rays, rgbs, n_iters=1 << 40,
                      generator=torch.Generator(device=device).manual_seed(ctx.seed))
    except _WindowClosed:
        pass
    window_s = rec["t1"] - rec["t0"]
    n_valid = float(sum(rec["valid"], torch.zeros((), device=device)))
    n_shaded = float(sum(rec["shaded"], torch.zeros((), device=device)))
    n_batch = trainer.cfg.batch_size
    per = rec["steps"] * n_batch * spec.n_samples
    failed = int((~torch.stack(rec["finite"])).sum()) if rec["finite"] else 0
    out = {"setup_s": rec["setup_end"] - ctx.t0, "attempted": rec["steps"], "failed": failed,
           "window_s": window_s,
           "e2e": {"train_rays_per_s": rec["steps"] * n_batch / window_s},
           "work": {"steps": rec["steps"], "gated_share": n_valid / per,
                    "shaded_share": n_shaded / per, "samples_per_ray": spec.n_samples,
                    "grid": list(spec.grid),
                    "setup_parts_s": {"scene": scene_s,
                                      "warm_steps": rec["setup_end"] - t_built}},
           "memory_peak_bytes": ctx.memory_peak()}
    if ctx.trace:
        dens, app = field_flops(spec)
        r = Readings(ctx.root, "train", rec["tr"], rec["traced_steps"], spec, "f32",
                     {"factor_sampling": rec["traced"]})
        r.mfu_pct = 100.0 * 3.0 * (dens * n_valid + app * n_shaded) / (
            window_s * work.peak_flops("f32"))
        out["readings"] = r
    batches = rec["batches"]
    del trainer, rec, rays, rgbs
    ctx.free()
    if len(batches) < 3 or "change" not in early:
        # the program's steps never reached its loss or its update
        out["failed"] = max(out["failed"], 1)
        out["checks"] = [(k, math.nan, v) for k, v in ctx.limits.items()]
        return out
    program = {"loss": [float(x) for x in early["loss"]],
               "grad": [float(x) for x in early["grad"]],
               "change": [float(x) for x in early["change"]]}
    if not all(math.isfinite(v) for v in program["loss"]):
        out["failed"] = max(out["failed"], 1)
    trace = ref.train_steps(spec, init, batches, first)
    out["checks"] = [(k, v, ctx.limits[k]) for k, v in train_gaps(program, trace).items()]
    out["work"]["leaves_left_out"] = kept(trace.grad_norms).count(False)
    return out



def shortest(mix: dict) -> dict:
    """Mix overrides of the shortest run that still checks (with
    ``--seconds 0``, one step past the warm steps)."""
    return {"warm_steps": 3}


def control(ctx, side: str) -> Dict[str, float]:
    """The numbers the check compares, with the reference in the program's
    place: its matrix products in TF32 (side "control"), or on the first
    half of each batch, the mean taken over it (side "half")."""
    dev = ctx.device
    trainer, spec, init, rays, rgbs = build(ctx.config, ctx.seed, dev)
    first = trainer.global_step
    del trainer
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    batches = []
    for ids in first_ids(rays.shape[0], spec.batch, 3):
        ids = torch.from_numpy(ids).to(dev)
        batches.append((rays[ids], rgbs[ids], torch.rand((len(ids), 1), generator=gen,
                                                         device=dev)))
    want = ref.train_steps(spec, init, batches, first, tf32=False)
    if side == "half":
        half = [tuple(t[:t.shape[0] // 2] for t in b) for b in batches]
        got = ref.train_steps(spec, init, half, first, tf32=False)
    else:
        got = ref.train_steps(spec, init, batches, first, tf32=True)
    return train_gaps({"loss": got.losses, "grad": got.grad_norms,
                       "change": got.change_norms}, want)
