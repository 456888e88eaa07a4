"""NeRF++ cells: a tensorf-myc NerfPlusPlus configuration (a TensoRF
foreground inside an inverted-sphere background MLP) trained at one stage
through ``TensoRFTrainer.train``, at a global step past every event, on
views of a synthetic object in front of an environment at infinity, which
the benchmark renders from the seed.

Set-up builds the trainer with ``cli/tensorf_train.build_family_trainer``
(the NerfPlusPlus forward, its background net and its draws), puts it at
the stage the configuration names (the TensoRF family's factor grids at
that resolution with the density shaped to the object, and the benchmark's
background MLP weights), runs the program's own alpha-mask update over it,
and trains ``warm_steps`` steps in the one call to ``train`` that also
carries the window. As in the TensoRF family, the harness hooks the
trainer's ``loss``, ``train_step`` and ``events`` to count the work and to
end the window after the first step past ``--seconds``.

The cameras sit inside the sphere of radius ``radii`` about the origin, as
the inverted-sphere parametrisation requires, on rings about the object's
vertical axis; the object lies beyond ``near``. Whatever the object leaves
uncovered shows the environment: a smooth, non-white colour of the ray's
direction, which the background model is built to learn.
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
from ..reference import tensorf_nerfpp as pref
from . import tensorf as tfam


def make_params(spec: pref.NerfPPSpec, obj: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The stage's parameters from the seed, on the device: the foreground's
    as the TensoRF family makes them (factor grids N(0, 0.1), the density
    shaped to the object, basis and MLP_Fea), and the background MLP's
    kernels truncated normal (variance 1/fan_in) from the next seed, biases
    zero."""
    out = tfam.make_params(spec.fg, obj, seed, device)
    g = torch.Generator(device=device).manual_seed((seed + 1) % (1 << 63))
    for k, (a, b) in enumerate(pref.bg_widths(spec)):
        t = torch.empty((a, b), device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        out[f"bg_net.Dense_{k}.kernel"] = t * (math.sqrt(1.0 / a) / 0.87962566103423978)
        out[f"bg_net.Dense_{k}.bias"] = torch.zeros(b, device=device)
    return out


def environment(u: torch.Tensor) -> torch.Tensor:
    """The colour [..., 3] seen at infinity along unit directions u: smooth,
    within (0.1, 0.9), brighter and bluer upward (+y)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([0.45 + 0.25 * torch.sin(2.0 * x + 1.5 * y) * torch.cos(1.2 * z),
                        0.50 + 0.20 * y + 0.15 * torch.cos(1.7 * z - 0.8 * x),
                        0.60 + 0.25 * y + 0.05 * torch.sin(2.9 * x + 1.1)], -1)


def camera(pos: np.ndarray, target: np.ndarray) -> torch.Tensor:
    """Camera-to-world [3, 4] at ``pos`` looking at ``target``, +y up."""
    fwd = (target - pos) / np.linalg.norm(target - pos)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return torch.tensor(np.concatenate([np.stack([right, down, fwd], 1), pos[:, None]], 1),
                        dtype=torch.float32)


def cameras(cfg: dict, seed: int):
    """Every view's camera, rings of (radius, height) about the vertical axis
    through the target, the orbit's phase drawn from the seed; each inside
    the sphere of radius ``radii``."""
    s = cfg["scene"]
    target = np.asarray(s["target"], np.float64)
    phase = float(np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi))
    per = s["views"] // len(s["rings"])
    out = []
    for i, (r, h) in enumerate(s["rings"]):
        for a in np.linspace(0, 2 * np.pi, per, endpoint=False) + phase + 0.45 * i:
            pos = np.array([target[0] + r * np.cos(a), h, target[2] + r * np.sin(a)])
            if np.linalg.norm(pos) >= cfg["tensorf"]["radii"]:
                raise ValueError(f"camera at {pos} is outside the sphere of radius "
                                 f"{cfg['tensorf']['radii']}")
            out.append(camera(pos, target))
    return out


@torch.no_grad()
def render(field, c2w: torch.Tensor, H: int, W: int, focal: float, depth_range, n: int,
           rows: int = 64) -> torch.Tensor:
    """Ground truth [H * W, 3] of ``field`` from one camera in front of the
    environment: n depths per ray, the NeRF quadrature, row strips."""
    out = []
    depth = torch.linspace(depth_range[0], depth_range[1], n, device=c2w.device)
    intv = torch.cat([depth[1:] - depth[:-1], depth.new_zeros(1)])
    for row0 in range(0, H, rows):
        o, d = scenes.pixel_rays(c2w, H, W, focal, row0, min(rows, H - row0))
        rgb_s, sigma = field(o[:, None, :] + d[:, None, :] * depth[None, :, None])
        norm = torch.linalg.norm(d, dim=-1, keepdim=True)
        sd = sigma * intv[None, :] * norm
        excl = torch.cumsum(torch.cat([torch.zeros_like(sd[:, :1]), sd[:, :-1]], -1), -1)
        w = torch.exp(-excl) * (1.0 - torch.exp(-sd))
        out.append((rgb_s * w[..., None]).sum(1)
                   + (1.0 - w.sum(1, keepdim=True)) * environment(d / norm))
    return torch.cat(out)


def make_rays(cfg: dict, seed: int, device):
    """(ray store [views * H * W, 6] of origins and unit directions, targets
    [views * H * W, 3]): the object's ellipsoid, centred in the box with the
    radii the density is shaped to, in front of the environment."""
    s, obj = cfg["scene"], cfg["object"]
    aabb = np.asarray(cfg["tensorf"]["bbox"], np.float64).reshape(2, 3)
    center, half = (aabb[0] + aabb[1]) / 2, (aabb[1] - aabb[0]) / 2
    field = scenes.ellipsoid_field(center.tolist(), (half * np.asarray(obj["radii"])).tolist())
    H, W, focal = s["H"], s["W"], s["focal_factor"] * s["W"]
    rays, rgbs = [], []
    for c in cameras(cfg, seed):
        c = c.to(device)
        rgbs.append(render(field, c, H, W, focal, tuple(s["depth_range"]), s["gt_samples"]))
        o, d = scenes.pixel_rays(c, H, W, focal)
        rays.append(torch.cat([o, d / torch.linalg.norm(d, dim=-1, keepdim=True)], -1))
    return torch.cat(rays), torch.cat(rgbs)


def build(config: dict, seed: int, device):
    """(trainer, spec, initial parameters by name, ray store, targets)."""
    from myc_nerfs_tpu_torch.cli.tensorf_train import build_configs, build_family_trainer
    from myc_nerfs_tpu_torch.models import tensorf as tf

    a = copy.deepcopy(config["tensorf"])
    model_cfg, train_cfg = build_configs(a)
    spec = pref.nerfpp_spec(config)
    aabb = np.asarray(a["bbox"], np.float32).reshape(2, 3)
    trainer = build_family_trainer(a, model_cfg, train_cfg, aabb,
                                   torch.Generator(device=device).manual_seed(0), device)
    init = make_params(spec, config["object"], seed, device)
    params = dict(trainer.params)
    for key in ("app_line", "app_plane", "density_line", "density_plane"):
        params[key] = [tf._leaf(init[f"{key}.{i}"].clone()) for i in range(3)]
    params["basis_mat"] = tf._leaf(init["basis_mat"].clone())
    with torch.no_grad():
        for module in ("mlp", "bg_net"):
            for name, p in params[module].named_parameters():
                p.copy_(init[f"{module}.{name}"])
    trainer.params = params
    trainer.geom = tf.compute_stage_geom(model_cfg, aabb, spec.fg.grid, train_cfg.n_samples_cap)
    trainer.voxel_schedule = []
    reso = tuple(min(g, train_cfg.alpha_mask_reso_cap) for g in spec.fg.grid)
    trainer.buffers, _ = tf.update_alpha_mask(model_cfg, trainer.geom, trainer.params,
                                              trainer.buffers, reso)
    trainer.set_step(config["stage"]["global_step"])
    trainer._rebuild(lr_scale=1.0)
    if (trainer.geom.n_samples, tuple(trainer.geom.grid_size)) != (spec.fg.n_samples,
                                                                    spec.fg.grid):
        raise RuntimeError(f"stage {trainer.geom} is not the configuration's {spec.fg}")
    sync()
    t = time.perf_counter()
    rays, rgbs = make_rays(config, seed, device)
    sync()
    trainer.scene_s = time.perf_counter() - t
    return trainer, spec, init, rays, rgbs


def bg_flops(spec: pref.NerfPPSpec) -> float:
    """Forward FLOPs of the background MLP per background sample."""
    return 2.0 * sum(a * b for a, b in pref.bg_widths(spec))


def _clone(draws):
    return tuple(d.detach().clone() for d in draws)


def run(ctx) -> dict:
    mix, device = ctx.mix, ctx.device
    trainer, spec, init, rays, rgbs = build(ctx.config, ctx.seed, device)
    first = trainer.global_step
    rec = {"phase": "warm", "n": 0, "steps": 0, "batches": [], "valid": [], "shaded": [],
           "bg_rays": [], "finite": [], "traced": [], "traced_shaded": [], "traced_steps": 0}
    early: Dict[str, list] = {}

    orig_loss = trainer.loss

    def loss(rays_b, rgbs_b, draws, params=None, step=None):
        total, mse, out = orig_loss(rays_b, rgbs_b, draws, params, step)
        if len(rec["batches"]) < 3:
            rec["batches"].append((rays_b.detach().clone(), rgbs_b.detach().clone(),
                                   _clone(draws)))
            early.setdefault("loss", []).append(total.detach().clone())
        if rec["phase"] == "window":
            rec["valid"].append(out.extras["valid"].sum())
            rec["shaded"].append(out.extras["app_mask"].sum())
            rec["bg_rays"].append((out.bg_weight > 0).sum())
        elif rec["phase"] == "trace":
            rec["traced"].append((rays_b.detach(), out.extras["valid"].detach(),
                                  out.extras["app_mask"].detach(), out.z_vals.detach()))
            rec["traced_shaded"].append((spec, out.extras["app_mask"].sum()))
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
            names = [n for n in pref.leaf_shapes(spec) if ref.is_spatial(n)] + \
                [n for n in pref.leaf_shapes(spec) if not ref.is_spatial(n)]
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
            raise tfam._WindowClosed
        return None

    trainer.loss, trainer.train_step, trainer.events = loss, train_step, events
    scene_s, t_built = trainer.scene_s, time.perf_counter()
    try:
        trainer.train(rays, rgbs, n_iters=1 << 40,
                      generator=torch.Generator(device=device).manual_seed(ctx.seed))
    except tfam._WindowClosed:
        pass
    window_s = rec["t1"] - rec["t0"]
    zero = torch.zeros((), device=device)
    n_valid, n_shaded = float(sum(rec["valid"], zero)), float(sum(rec["shaded"], zero))
    n_bg_rays = float(sum(rec["bg_rays"], zero))
    n_batch = trainer.cfg.batch_size
    per = rec["steps"] * n_batch * spec.fg.n_samples
    bg_rows = rec["steps"] * n_batch * spec.bg_samples
    failed = int((~torch.stack(rec["finite"])).sum()) if rec["finite"] else 0
    peak = ctx.memory_peak()
    out = {"setup_s": rec["setup_end"] - ctx.t0, "attempted": rec["steps"], "failed": failed,
           "window_s": window_s,
           "e2e": {"train_rays_per_s": rec["steps"] * n_batch / window_s},
           "work": {"steps": rec["steps"], "grid": list(spec.fg.grid),
                    "fg_samples_per_ray": spec.fg.n_samples,
                    "bg_samples_per_step": n_batch * spec.bg_samples,
                    "gated_share": n_valid / per if per else 0.0,
                    "shaded_share": n_shaded / per if per else 0.0,
                    "bg_ray_share": n_bg_rays / (rec["steps"] * n_batch) if per else 0.0,
                    "memory_peak_bytes": peak,
                    "setup_parts_s": {"scene": scene_s,
                                      "warm_steps": rec["setup_end"] - t_built}},
           "memory_peak_bytes": peak}
    if ctx.trace:
        dens, app = tfam.field_flops(spec.fg)
        r = Readings(ctx.root, "train", rec["tr"], rec["traced_steps"], spec.fg, "f32",
                     {"factor_sampling": rec["traced"], "mlp_gemm": rec["traced_shaded"]})
        r.mfu_pct = 100.0 * 3.0 * (dens * n_valid + app * n_shaded + bg_flops(spec) * bg_rows) / (
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
    trace = pref.train_steps(spec, init, batches, first)
    out["checks"] = [(k, v, ctx.limits[k]) for k, v in train_gaps(program, trace).items()]
    out["work"]["leaves_left_out"] = kept(trace.grad_norms).count(False)
    return out


# the shortest run that still checks: as the TensoRF family's
shortest = tfam.shortest


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
    for ids in first_ids(rays.shape[0], spec.fg.batch, 3):
        ids = torch.from_numpy(ids).to(dev)
        draws = (torch.rand((len(ids), spec.fg.n_samples), generator=gen, device=dev),
                 torch.rand((len(ids), spec.bg_samples), generator=gen, device=dev))
        batches.append((rays[ids], rgbs[ids], draws))
    want = pref.train_steps(spec, init, batches, first, tf32=False)
    if side == "half":
        half = [(r[:r.shape[0] // 2], t[:t.shape[0] // 2],
                 tuple(d[:d.shape[0] // 2] for d in draws)) for r, t, draws in batches]
        got = pref.train_steps(spec, init, half, first, tf32=False)
    else:
        got = pref.train_steps(spec, init, batches, first, tf32=True)
    return train_gaps({"loss": got.losses, "grad": got.grad_norms,
                       "change": got.change_norms}, want)
