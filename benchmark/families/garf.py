"""GARF cells: barf-myc's joint pose refinement (a gaussian-activated MLP
field and per-view se(3) corrections, options/Easyship.yaml) trained past
its pose gate through the port's MLP-family train step, on views of a
synthetic object that the benchmark renders from the seed.

Set-up builds the run as ``cli/train.py`` does: the configuration's barf
options through ``cli/train.config_to_train_config``, ``nerf_trainer.
init_state`` from a torch.Generator of the seed, and ``make_train_step``
over the views. It then puts the benchmark's own state in the program's,
as the NeRF++ family does: the MLP's 16 leaves from the seed in barf's
TF-Xavier form (``make_params``), the step and both Adams' counts at the
configuration's global step, past the gate, the first moments and the
corrections zero, and second moments at the gradients' scale
(``make_moments``), as a run that far along holds them. Each step's draws
are the benchmark's too (``draw``: the pixels without replacement, as the
published code draws them, then the jitter), from a generator of its own,
and go to the program's step and to the reference alike. It runs
``warm_steps`` steps; the window runs whole steps, one after another,
until ``--seconds`` have passed, and ends in a synchronise.

The views: an object at the origin (``lib/scenes.ellipsoid_field``, its
radii from the seed) over white, seen from cameras on the upper half of a
sphere about it, each looking at the origin, rendered on the device
(``lib/scenes.render``); the given poses are the exact ones (the
configuration's camera noise is 0).

The check: the reference (``reference/garf.py``) takes the run's first
three steps with the same draws, each step from the state the program
started it from (the reference's own Adam moments carried on), and adds
up its updates. A reference left to follow its own steps drifts from the
program by the last bits of each update, which the gaussian field (sigma
0.1) spreads until a ReLU density crosses zero on one side alone: in a
ray's last sample (interval 1e10) that turns the ray from opaque to
clear, a loss gap past any limit that reads rounding. ``loss_gap``,
``grad_gap`` and ``change_gap`` over the MLP's leaves as the other train
cells read them (``lib/checks.train_gaps``), and ``pose_gap``, the
corrections' first gradient and three-step change each against the
reference on their own norm.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..lib import scenes, work
from ..lib.checks import train_gaps
from ..lib.profile import Trace
from ..lib.readings import Readings, settle, sync
from ..reference import garf as gref


class Run(NamedTuple):
    tcfg: object                     # the program's NeRFTrainConfig
    spec: gref.GarfSpec
    state: object                    # the program's NeRFTrainState at the global step
    init: Dict[str, torch.Tensor]    # the MLP's leaves at the start, by name
    nu: Dict[str, torch.Tensor]      # both Adams' second moments, by leaf and "se3_refine"
    images: torch.Tensor             # [V, H, W, 3]
    poses: torch.Tensor              # [V, 3, 4] world to camera
    intr: torch.Tensor               # [V, 3, 3]
    gen: torch.Generator             # the draws' generator, past the moments' draw
    scene_s: float


def _generator(seed: int, k: int, device) -> torch.Generator:
    """The seed's k-th generator: the program's init 0, the weights 1, the
    draws 2, the moments 3."""
    return torch.Generator(device=device).manual_seed((seed + k) % (1 << 63))


def make_params(spec: gref.GarfSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The MLP's leaves from the seed, in barf's TF-Xavier form (nerf.py
    tensorflow_init_weights over each nn.Linear weight [out, in]): uniform
    within gain * sqrt(6 / (fan_in + fan_out)), gain sqrt(2) on the hidden
    layers, 1 on the rgb output; the density layer's row 0 over its own
    slice (fan_out 1, gain 1), its other rows gain sqrt(2); biases zero.
    Kernels in the port's layout, [in, out]."""
    g = _generator(seed, 1, device)
    widths = gref.layer_widths(spec)
    n_feat = len(spec.widths_feat)

    def xavier(rows: int, cols: int, gain: float) -> torch.Tensor:
        bound = gain * math.sqrt(6.0 / (cols + rows))
        return (torch.rand((rows, cols), generator=g, device=device) * 2.0 - 1.0) * bound

    out = {}
    for i, (fan_in, fan_out) in enumerate(widths):
        if i == n_feat - 1:
            w = torch.cat([xavier(1, fan_in, 1.0), xavier(fan_out - 1, fan_in, math.sqrt(2.0))])
        else:
            w = xavier(fan_out, fan_in, 1.0 if i == len(widths) - 1 else math.sqrt(2.0))
        out[f"Dense_{i}.kernel"] = w.t().contiguous()
        out[f"Dense_{i}.bias"] = torch.zeros(fan_out, device=device)
    return out


def draw(tcfg, V: int, H: int, W: int, gen: torch.Generator, device):
    """One step's draws as the published code makes them (nerf.py:
    ``randperm(H * W)[:rand_rays // views]``, the same pixels in every view,
    then the stratified jitter [V, R, N, 1] in [0, 1))."""
    from myc_nerfs_tpu_torch.train.nerf_trainer import StepDraws

    R = max(tcfg.rand_rays // V, 1)
    ray_idx = torch.randperm(H * W, generator=gen, device=device)[:R]
    depth = torch.rand((V, R, tcfg.sample_intvs, 1), generator=gen, device=device)
    return StepDraws(ray_idx=ray_idx, depth=depth)


def make_moments(spec: gref.GarfSpec, init: Dict[str, torch.Tensor], se3: torch.Tensor,
                 step: int, views, batch, seed: int) -> Dict[str, torch.Tensor]:
    """Both Adams' second moments at the global step, by leaf name and
    "se3_refine": each element the leaf's mean square gradient (the
    reference's, on one draw before the checked steps) times exp(z), z
    standard normal from the seed. A state that far along holds moments of
    that scale; with them every update is smooth in its gradient, where
    zero moments make Adam's first step ~3.16 lr times the gradient's sign,
    which rounding flips on the elements near zero."""
    images, poses, intr = views
    _, grads = gref.gradients(spec, init, se3, step, images, poses, intr, batch.ray_idx,
                              batch.depth)
    g = _generator(seed, 3, se3.device)
    out = {}
    for name, grad in zip(gref.leaf_names(spec) + ["se3_refine"], grads):
        mean_sq = grad.detach().float().square().mean().clamp_min(1e-30)
        z = torch.randn(grad.shape, generator=g, device=grad.device)
        out[name] = mean_sq * torch.exp(z)
    return out


def cameras(cfg: dict, seed: int) -> torch.Tensor:
    """Camera-to-world [V, 3, 4] (x right, y down, z forward) on the upper
    half of the sphere of radius ``scene.radius`` about the origin, each
    looking at it: a golden-angle spiral between the elevations
    ``scene.elevation`` (degrees), its phase from the seed."""
    s = cfg["scene"]
    V, radius = s["views"], float(s["radius"])
    lo, hi = (math.radians(e) for e in s["elevation"])
    phase = float(np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi))
    golden = math.pi * (3.0 - math.sqrt(5.0))
    out = []
    for k in range(V):
        el = math.asin(math.sin(lo) + (math.sin(hi) - math.sin(lo)) * (k + 0.5) / V)
        az = phase + golden * k
        pos = radius * np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
                                 math.sin(el)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        out.append(np.concatenate([np.stack([right, down, fwd], 1), pos[:, None]], 1))
    return torch.tensor(np.stack(out), dtype=torch.float32)


def make_views(cfg: dict, seed: int, device):
    """(images [V, H, W, 3], poses [V, 3, 4] world to camera, intr
    [V, 3, 3]) of the seed's object, rendered on ``device``."""
    s = cfg["scene"]
    H, W = cfg["barf"]["data"]["image_size"]
    radii = np.random.default_rng(seed + 1).uniform(*s["object_radii"], size=3)
    obj = scenes.ellipsoid_field((0.0, 0.0, 0.0), radii.tolist())
    focal = 0.5 * W / math.tan(0.5 * s["camera_angle_x"])
    depth = tuple(float(v) for v in cfg["barf"]["nerf"]["depth"]["range"])
    c2w = cameras(cfg, seed).to(device)
    images = torch.stack([scenes.render(obj, c, H, W, focal, depth, s["gt_samples"],
                                        rows=s["render_rows"]) for c in c2w])
    R, t = c2w[:, :, :3], c2w[:, :, 3:]
    poses = torch.cat([R.transpose(1, 2), -R.transpose(1, 2) @ t], -1)
    intr = torch.tensor([[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]],
                        device=device).expand(len(c2w), 3, 3).contiguous()
    return images, poses, intr


def _same(tcfg, spec: gref.GarfSpec) -> bool:
    """Whether the program's train config is the configuration the
    reference reads."""
    return (tcfg.model == "garf" and tcfg.refine_pose and tcfg.widths_feat == spec.widths_feat
            and tcfg.widths_rgb == spec.widths_rgb and tcfg.skip == spec.skip
            and tuple(map(float, tcfg.depth_range)) == spec.depth_range
            and tcfg.sample_intvs == spec.n_samples and tcfg.rand_rays == spec.rand_rays
            and tcfg.sample_stratified and not tcfg.fine_sampling and not tcfg.camera_noise
            and not tcfg.density_noise_reg and not tcfg.setbg_opaque and not tcfg.use_bf16
            and (tcfg.lr, tcfg.lr_end, tcfg.lr_pose, tcfg.lr_pose_end, tcfg.max_iter,
                 tcfg.start_pose_correct_iter, tcfg.warmup_pose)
            == (spec.lr, spec.lr_end, spec.lr_pose, spec.lr_pose_end, spec.max_iter,
                spec.start_pose_correct_iter, 0))


def build(config: dict, seed: int, device) -> Run:
    from myc_nerfs_tpu_torch.cli.train import config_to_train_config
    from myc_nerfs_tpu_torch.core.config import Config
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    barf = copy.deepcopy(config["barf"])
    tcfg = config_to_train_config(Config.wrap(barf))
    spec = gref.garf_spec(barf)
    if not _same(tcfg, spec):
        raise RuntimeError(f"the program's train config {tcfg} is not the reference's {spec}")
    sync()
    t = time.perf_counter()
    images, poses, intr = make_views(config, seed, device)
    sync()
    scene_s = time.perf_counter() - t
    V, H, W = images.shape[:3]
    first = config["stage"]["global_step"]
    state = nt.init_state(tcfg, _generator(seed, 0, device), V, device)
    init = make_params(spec, seed, device)
    gen = _generator(seed, 2, device)
    nu = make_moments(spec, init, state.se3_refine, first, (images, poses, intr),
                      draw(tcfg, V, H, W, gen, device), seed)
    names = gref.leaf_names(spec)
    with torch.no_grad():
        for n, leaf in zip(names, state.params.param_list()):
            leaf.copy_(init[n])
    at = torch.tensor(first, dtype=torch.int32, device=device)
    state = state._replace(
        step=at.clone(),
        opt_state=state.opt_state._replace(count=at.clone(),
                                           nu=[nu[n].clone() for n in names]),
        opt_state_pose=state.opt_state_pose._replace(count=at.clone(),
                                                     nu=[nu["se3_refine"].clone()]))
    return Run(tcfg, spec, state, init, nu, images, poses, intr, gen, scene_s)


def field_flops(spec: gref.GarfSpec) -> float:
    """Forward FLOPs of the field per sample."""
    return 2.0 * gref.macs_per_sample(spec)


def run(ctx) -> dict:
    from myc_nerfs_tpu_torch.train import nerf_trainer as nt

    mix, dev = ctx.mix, ctx.device
    b = build(ctx.config, ctx.seed, dev)
    # the moments' reference pass is the benchmark's set-up, not the program's memory
    ctx.free()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tcfg, spec, state = b.tcfg, b.spec, b.state
    first = ctx.config["stage"]["global_step"]
    if mix.get("gate_open") and first < spec.start_pose_correct_iter:
        raise ValueError(f"global step {first} is before the pose gate "
                         f"{spec.start_pose_correct_iter}")
    V, H, W = b.images.shape[:3]
    se3_0 = state.se3_refine.clone()
    step = nt.make_train_step(tcfg, b.images, b.poses, b.intr)
    rays = V * max(tcfg.rand_rays // V, 1)
    samples = rays * tcfg.sample_intvs

    def one(state):
        draws = draw(tcfg, V, H, W, b.gen, dev)
        new, metrics = step(state, draws)
        return new, metrics, draws

    b1 = nt.BETAS[0]
    names = gref.leaf_names(spec)
    batches, losses, states, early = [], [], [], {}
    t_built = time.perf_counter()
    for i in range(mix["warm_steps"]):
        if i < 3:
            states.append(({n: t.detach().clone() for n, t in
                            zip(names, state.params.param_list())},
                           state.se3_refine.detach().clone()))
        state, metrics, draws = one(state)
        if i < 3:
            batches.append((draws.ray_idx.clone(), draws.depth.clone()))
            losses.append(metrics["loss"])
        if i == 0:
            early["grad"] = [torch.linalg.norm(m / (1.0 - b1)) for m in state.opt_state.mu]
            early["pose_grad"] = state.opt_state_pose.mu[0] / (1.0 - b1)
        elif i == 2:
            early["change"] = [torch.linalg.norm(t.detach() - b.init[n]) for n, t in
                               zip(names, state.params.param_list())]
            early["pose_change"] = state.se3_refine - se3_0
    settle()
    setup_end = time.perf_counter()
    tr = None
    if ctx.trace:
        tr = Trace()
        tr.start()
        for _ in range(mix["trace_steps"]):
            state, _, _ = one(state)
        tr.stop()
    finite, n = [], 0
    t0 = time.perf_counter()
    while True:
        state, metrics, _ = one(state)
        finite.append(torch.isfinite(metrics["loss"]))
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    failed = int((~torch.stack(finite)).sum())
    gate_open = bool(state.step - 1 >= spec.start_pose_correct_iter)
    peak = ctx.memory_peak()
    out = {"setup_s": setup_end - ctx.t0, "attempted": n, "failed": failed,
           "window_s": window_s, "e2e": {"train_rays_per_s": n * rays / window_s},
           "work": {"steps": n, "views": V, "rays_per_step": rays,
                    "samples_per_step": samples, "pose_gate_open": gate_open,
                    "memory_peak_bytes": peak,
                    "setup_parts_s": {"scene": b.scene_s, "warm_steps": setup_end - t_built}},
           "memory_peak_bytes": peak}
    if ctx.trace:
        r = Readings(ctx.root, "train", tr, mix["trace_steps"], spec, "f32",
                     {"nerf_gemm": [spec]})
        r.mfu_pct = 100.0 * 3.0 * field_flops(spec) * samples * n / (
            window_s * work.peak_flops("f32"))
        out["readings"] = r
    images, poses, intr = b.images, b.poses, b.intr
    init, nu = b.init, b.nu
    del b, state, step, metrics
    ctx.free()
    if len(batches) < 3:
        # the run never reached a third step
        out["failed"] = max(out["failed"], 1)
        out["checks"] = [(k, math.nan, v) for k, v in ctx.limits.items()]
        return out
    program = {"loss": [float(x) for x in losses], "grad": [float(x) for x in early["grad"]],
               "change": [float(x) for x in early["change"]]}
    if not all(math.isfinite(v) for v in program["loss"]):
        out["failed"] = max(out["failed"], 1)
    trace = gref.train_steps(spec, init, se3_0, images, poses, intr, batches, first, nu,
                             states=states)
    gaps = train_gaps(program, trace)
    gaps["pose_gap"] = pose_gap(early["pose_grad"], early["pose_change"], trace)
    out["checks"] = [(k, v, ctx.limits[k]) for k, v in gaps.items()]
    return out


def pose_gap(grad: torch.Tensor, change: torch.Tensor, trace: gref.TrainTrace) -> float:
    """The corrections' worst gap to the reference on their own norm: of
    the first gradient and of the change over the steps, each the norm of
    the difference over the reference's norm."""
    def gap(a, b):
        b = b.to(a.device)
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-30))
    return max(gap(grad, trace.pose_grad), gap(change, trace.pose_change))


def shortest(mix: dict) -> dict:
    """Mix overrides of the shortest run that still checks (with
    ``--seconds 0``, one step past the warm steps)."""
    return {"warm_steps": 3}


def control(ctx, side: str) -> Dict[str, float]:
    """The numbers the check compares, with the reference in the program's
    place: its matrix products in TF32 (side "control"), or on the first
    half of each step's pixels, the mean taken over them (side "half"),
    its own three steps; the f32 reference takes each from where that run
    started it, as the check does."""
    b = build(ctx.config, ctx.seed, ctx.device)
    V, H, W = b.images.shape[:3]
    batches = []
    for _ in range(3):
        d = draw(b.tcfg, V, H, W, b.gen, ctx.device)
        batches.append((d.ray_idx, d.depth))
    first = ctx.config["stage"]["global_step"]
    se3_0 = b.state.se3_refine.clone()
    args = (b.spec, b.init, se3_0, b.images, b.poses, b.intr, batches, first, b.nu)
    if side == "half":
        got = gref.train_steps(*args, tf32=False, rays=batches[0][0].shape[0] // 2)
    else:
        got = gref.train_steps(*args, tf32=True)
    want = gref.train_steps(*args, tf32=False, states=got.states)
    gaps = train_gaps({"loss": got.losses, "grad": got.grad_norms,
                       "change": got.change_norms}, want)
    gaps["pose_gap"] = pose_gap(got.pose_grad, got.pose_change, want)
    return gaps
