"""Instant-NGP cells: a run_net configuration trained through
``cli/run_net.train_loop`` (mode "train") or rendered whole-frame through
``NGPTrainer.render_image`` (mode "render").

Mode "train": set-up builds the trainer with ``run_net.build_trainer`` and
the cameras of a synthetic scene that the benchmark renders, writes the
benchmark's initial weights (from the seed) into it, and trains
``warm_steps`` steps in the one call to ``train_loop`` that also carries the
window, so that the batch stream (``RayBatcher``) runs on unbroken. The
harness hooks the trainer's own methods (``train_block``,
``_update_batch_rays``, ``update``, ``grid_update``; in a traced run also
``model.encode`` and ``model.net._mlp``) to count the work and to end the
window at the first block boundary past ``--seconds``.

Mode "render": set-up writes a field state that the benchmark makes itself
into the trainer: tables and MLP weights from the seed, and an occupancy
grid of the scene's closed-form density. The reference renders from that
same state, so it takes nothing the program made.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..lib import scenes, work
from ..lib.checks import first_ids, kept, train_gaps
from ..lib.profile import Trace, span
from ..lib.readings import Readings, settle, sync
from ..reference import ngp as ref

# world -> NGP box (the port's synthetic scenes), NGP = world * SCALE + OFF
SCALE, OFF = 0.33, 0.5


class _WindowClosed(Exception):
    """Raised at a block boundary to end train_loop once the window closes."""


# ---------------------------------------------------------------------------
# inputs made from the seed
# ---------------------------------------------------------------------------


class SceneData:
    """The scene's training views as run_net's data object: host arrays of
    NGP-space rays and targets over a white background, the cameras for
    the occupancy grid's initial state, and a record of the first ``keep``
    pixel batches the trainer asks for. The rings' phase is the
    configuration's, the same for every seed, so that every seed trains
    on the same views."""

    fixed_bg = (1.0, 1.0, 1.0)

    def __init__(self, spec: dict, device, keep: int = 3):
        H, W, n = spec["H"], spec["W"], spec["views"]
        self.H, self.W, self.focal = H, W, spec["focal_factor"] * W
        phase = spec["phase"]
        rings = spec["rings"]
        per = n // len(rings)
        self.c2w = torch.cat([scenes.orbit(per, r, e, phase + 0.45 * i)
                              for i, (r, e) in enumerate(rings)]).to(device)
        images, o, d = [], [], []
        for c in self.c2w:
            images.append(scenes.render(scenes.detail_field, c, H, W, self.focal,
                                        tuple(spec["depth_range"]), spec["gt_samples"]))
            oo, dd = scenes.pixel_rays(c, H, W, self.focal)
            o.append(oo * SCALE + OFF)
            d.append(dd / torch.linalg.norm(dd, dim=-1, keepdim=True))
        self.n_images, self.n_pixels = len(images), H * W
        self.images = torch.stack(images).reshape(n, -1, 3).cpu().numpy()
        self._o = torch.stack(o).cpu().numpy()
        self._d = torch.stack(d).cpu().numpy()
        self.keep = keep
        self.batches: List = []
        self.traced = False

    def cameras(self) -> torch.Tensor:
        """NGP-space camera-to-world [n, 3, 4]."""
        return torch.cat([self.c2w[:, :, :3], self.c2w[:, :, 3:] * SCALE + OFF], 2)

    def rays_for_pixels(self, img_ids, pix_ids):
        if len(self.batches) < self.keep:
            self.batches.append((np.array(img_ids), np.array(pix_ids)))
        with span("data", self.traced):
            return self._o[img_ids, pix_ids], self._d[img_ids, pix_ids]

    def pixel_values(self, img_ids, pix_ids, bg=None):
        with span("data", self.traced):
            return self.images[img_ids, pix_ids]


def make_weights(spec: ref.NGPSpec, seed: int, device, mlp_dtype, table_scale: float = 1e-4,
                 density_gain: Optional[float] = None):
    """Tables (uniform +-table_scale, f32) and MLP weights (truncated normal,
    variance 1/fan_in, in the MLPs' dtype) from the seed, on the device, in
    two draws. With ``density_gain``, the density output's column of the
    last density layer is taken in absolute value and scaled by it, so that
    the field is dense where the occupancy grid lets samples through."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ref.table_shapes(spec)
    flat = torch.empty(sum(r * c for r, c in shapes), device=device)
    flat.uniform_(-table_scale, table_scale, generator=g)
    tables, a = [], 0
    for r, c in shapes:
        tables.append(flat[a:a + r * c].reshape(r, c).clone())
        a += r * c
    layers = ref.layer_shapes(spec)
    z = torch.empty(sum(i * o for i, o in layers.values()), device=device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=g)
    weights, a = {}, 0
    for name, (i, o) in layers.items():
        std = math.sqrt(1.0 / i) / 0.87962566103423978
        w = z[a:a + i * o].reshape(i, o) * std
        if density_gain is not None and name == "density1":
            w[:, 0] = w[:, 0].abs() * density_gain
        weights[name] = w.to(mlp_dtype)
        a += i * o
    return tables, weights


def build_program(config: dict, device, cams: torch.Tensor, focal: float, W: int, H: int):
    """(trainer, train config, spec): run_net.build_trainer over cameras
    ``cams`` (NGP-space camera-to-world [n, 3, 4])."""
    from myc_nerfs_tpu_torch.cli.run_net import build_trainer

    run_net = copy.deepcopy(config["run_net"])
    trainer, tcfg = build_trainer(run_net, torch.Generator(device=device).manual_seed(0),
                                  device=device, camera_c2w=cams,
                                  focal=torch.full((cams.shape[0], 2), focal, device=device),
                                  image_wh=(W, H))
    return trainer, tcfg, ref.ngp_spec(run_net)


def mlp_dtype(config: dict):
    return torch.bfloat16 if config["run_net"].get("fp16") else torch.float32


def load_params(trainer, tables, weights) -> None:
    """Write the benchmark's tables and weights into the trainer's model."""
    params = trainer.model.param_list()
    with torch.no_grad():
        for p, v in zip(params, list(tables) + [weights[n] for n in ref.LAYERS]):
            if p.shape != v.shape or p.dtype != v.dtype:
                raise RuntimeError(f"parameter {tuple(p.shape)} {p.dtype} is not the "
                                   f"configuration's {tuple(v.shape)} {v.dtype}")
            p.copy_(v)


def build(config: dict, seed: int, device):
    """(trainer, train config, data, spec, initial tables, initial weights)."""
    t = time.perf_counter()
    data = SceneData(config["scene"], device)
    sync()
    data.scene_s = time.perf_counter() - t
    trainer, tcfg, spec = build_program(config, device, data.cameras(), data.focal,
                                        data.W, data.H)
    tables, weights = make_weights(spec, seed, device, mlp_dtype(config))
    load_params(trainer, tables, weights)
    return trainer, tcfg, data, spec, tables, weights


# ---------------------------------------------------------------------------
# the traced run's records
# ---------------------------------------------------------------------------


class CallLog:
    """While on, the positions of every encode call and the shape of every
    MLP call, each with whether autograd will run its backward."""

    def __init__(self, model):
        self.model = model
        self.encode: List = []
        self.mlp: List = []

    def on(self):
        model, net = self.model, self.model.net
        encode, mlp = model.encode, net._mlp

        def enc(positions):
            self.encode.append((positions.detach(), torch.is_grad_enabled()))
            return encode(positions)

        def mlp_call(x, weights):
            grad = torch.is_grad_enabled() and any(w.requires_grad for w in weights)
            self.mlp.append((x.shape[0], [x.shape[1]] + [w.shape[1] for w in weights],
                             "bf16" if x.dtype == torch.bfloat16 else "f32", grad))
            return mlp(x, weights)

        model.encode, net._mlp = enc, mlp_call

    def off(self):
        del self.model.encode, self.model.net._mlp

    def records(self) -> Dict[str, list]:
        return {"encode": self.encode, "mlp": self.mlp}


def field_flops(spec: ref.NGPSpec) -> float:
    """Forward FLOPs of the field per sample: the density and rgb MLPs."""
    L = spec.n_levels * spec.n_features
    return (work.mlp_flops([L, spec.density_hidden, spec.geo_feat], 1)
            + work.mlp_flops([spec.geo_feat + 16, spec.rgb_hidden, spec.rgb_hidden, 3], 1))


# ---------------------------------------------------------------------------
# mode "train": run_net.train_loop
# ---------------------------------------------------------------------------


def run_train(ctx) -> dict:
    mix, device = ctx.mix, ctx.device
    trainer, tcfg, data, spec, tables0, weights0 = build(ctx.config, ctx.seed, device)
    from myc_nerfs_tpu_torch.cli.run_net import train_loop

    S = tcfg.update_den_freq
    dtype = "bf16" if ctx.config["run_net"].get("fp16") else "f32"
    calls = CallLog(trainer.model)
    trace = Trace() if ctx.trace else None
    rec = {"phase": "warm", "blocks": 0, "first": None, "rays": 0, "steps": 0,
           "samples": [], "finite": [], "grid_s": [], "traced_steps": 0,
           "batch": [(0, trainer.n_rays_per_batch)]}
    start = [t.detach().clone() for t in tables0] + [weights0[n] for n in ref.LAYERS]
    params = trainer.model.param_list()
    early: Dict[str, list] = {}
    b1 = tcfg.betas[0]

    orig_update = trainer.update

    def update(grads):
        out = orig_update(grads)
        n = trainer.state.step
        if n == 1:
            early["grad"] = [torch.linalg.norm(
                m.float() / torch.tensor(1.0 - b1, dtype=m.dtype).float())
                for m in trainer.state.opt_state.mu]
        elif n == 3:
            early["change"] = [torch.linalg.norm(p.detach().float() - p0.float())
                               for p, p0 in zip(params, start)]
            start.clear()
            del trainer.update
        return out

    orig_block = trainer.train_block

    def train_block(rays_o, rays_d, target, bg=None, xi=None, generator=None):
        with span("train_block", rec["phase"] == "trace"):
            m = orig_block(rays_o, rays_d, target, bg=bg, xi=xi, generator=generator)
        if rec["first"] is None:
            rec["first"] = m["loss"][:3].detach().clone()
        if rec["phase"] == "window":
            rec["rays"] += rays_o.shape[0] * rays_o.shape[1]
            rec["steps"] += rays_o.shape[0]
            rec["samples"].append(m["n_samples"].sum())
            rec["finite"].append(m["finite"])
        elif rec["phase"] == "trace":
            rec["traced_steps"] += rays_o.shape[0]
        return m

    orig_grid = trainer.grid_update

    def grid_update(state, generator=None, draws=None):
        if rec["phase"] != "trace":
            return orig_grid(state, generator, draws)
        sync()
        t = time.perf_counter()
        with span("grid_update"):
            out = orig_grid(state, generator, draws)
        sync()
        rec["grid_s"].append(time.perf_counter() - t)
        return out

    orig_adapt = trainer._update_batch_rays
    warm_blocks = mix["warm_steps"] // S

    def after_block():
        with span("adapt_batch", rec["phase"] == "trace"):
            orig_adapt()
        rec["blocks"] += 1
        if trainer.n_rays_per_batch != rec["batch"][-1][1]:
            rec["batch"].append((rec["blocks"] * S, trainer.n_rays_per_batch))
        phase = rec["phase"]
        if phase == "warm" and rec["blocks"] >= warm_blocks:
            settle()
            rec["setup_end"] = time.perf_counter()
            if trace is not None:
                rec["phase"], rec["trace_left"] = "trace", mix["trace_steps"] // S
                calls.on()
                data.traced = True
                trace.start()
            else:
                rec["phase"], rec["t0"] = "window", time.perf_counter()
        elif phase == "trace":
            rec["trace_left"] -= 1
            if rec["trace_left"] == 0:
                trace.stop()
                calls.off()
                data.traced = False
                rec["phase"], rec["t0"] = "window", time.perf_counter()
        elif phase == "window" and time.perf_counter() - rec["t0"] >= ctx.seconds:
            sync()
            rec["t1"] = time.perf_counter()
            raise _WindowClosed

    trainer.update, trainer.train_block = update, train_block
    trainer.grid_update, trainer._update_batch_rays = grid_update, after_block
    t_built = time.perf_counter()
    loop_gen = torch.Generator(device=device).manual_seed(ctx.seed)
    try:
        train_loop(trainer, tcfg, data, 1 << 40, loop_gen, log=lambda *a: None)
    except _WindowClosed:
        pass
    window_s = rec["t1"] - rec["t0"]
    samples = float(torch.stack(rec["samples"]).sum())
    finite = torch.cat(rec["finite"])
    out = {"setup_s": rec["setup_end"] - ctx.t0, "attempted": rec["steps"],
           "failed": int((~finite).sum()), "window_s": window_s,
           "e2e": {"train_rays_per_s": rec["rays"] / window_s},
           "work": {"steps": rec["steps"], "samples_per_step": samples / rec["steps"],
                    "rays_per_step": rec["rays"] / rec["steps"],
                    "batch_changes": rec["batch"],
                    "setup_parts_s": {"scene": data.scene_s,
                                      "warm_steps": rec["setup_end"] - t_built}},
           "memory_peak_bytes": ctx.memory_peak()}
    grid_rows = tcfg.n_grid_uniform + tcfg.n_grid_nonuniform
    flops = (3.0 * field_flops(spec) * samples
             + rec["steps"] // S * grid_rows * work.mlp_flops(
                 [spec.n_levels * spec.n_features, spec.density_hidden, spec.geo_feat], 1))
    if trace is not None:
        r = Readings(ctx.root, "train", trace, rec["traced_steps"], spec, dtype, calls.records())
        r.grid_update_s = rec["grid_s"]
        r.mfu_pct = 100.0 * flops / (window_s * work.peak_flops(dtype))
        out["readings"] = r
    program = {"loss": [float(x) for x in rec["first"]],
               "grad": [float(x) for x in early["grad"]],
               "change": [float(x) for x in early["change"]]}
    batches, cams = data.batches, data.cameras()
    del trainer, params, calls
    ctx.free()
    out["checks"], out["work"]["leaves_left_out"] = check_train(
        ctx, spec, data, batches, cams, tables0, weights0, program, ctx.limits)
    return out


def first_inputs(spec: ref.NGPSpec, data: SceneData, batches, seed: int, device):
    """The reference's inputs for the first steps: the grid-update draws and
    each step's (rays_o, rays_d, target, bg, jitter), the draws from a
    generator seeded as the loop's, in the loop's order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = (ref.grid_draws(spec, spec.n_grid_uniform, gen, device),
             ref.grid_draws(spec, spec.n_grid_nonuniform, gen, device))
    out = []
    for img, pix in batches:
        xi = torch.rand((len(img), 1), generator=gen, device=device)
        f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
        bg = torch.tensor(data.fixed_bg, device=device).expand(len(img), 3)
        out.append((f(data._o[img, pix]), f(data._d[img, pix]),
                    f(data.images[img, pix]), bg, xi))
    return draws, out


def check_train(ctx, spec, data, batches, cams, tables0, weights0, program, limits):
    occ0 = ref.initial_occupancy(cams, torch.full((cams.shape[0], 2), data.focal,
                                                  device=cams.device), data.W, data.H)
    draws, inputs = first_inputs(spec, data, batches, ctx.seed, ctx.device)
    trace = ref.train_steps(spec, tables0, weights0, occ0, draws, inputs, "f32")
    return ([(k, v, limits[k]) for k, v in train_gaps(program, trace).items()],
            kept(trace.grad_norms).count(False))


# ---------------------------------------------------------------------------
# mode "render": NGPTrainer.render_image, whole frames
# ---------------------------------------------------------------------------


def render_views(mix: dict, device) -> List[torch.Tensor]:
    """The fixed orbit the window renders (NGP space), the same for every seed."""
    c2w = scenes.orbit(mix["views"], mix["radius"], mix["elevation"], 0.0).to(device)
    return [torch.cat([c[:, :3], c[:, 3:] * SCALE + OFF], 1) for c in c2w]


def view_rays(c2w: torch.Tensor, H: int, W: int, focal: float):
    o, d = scenes.pixel_rays(c2w, H, W, focal)
    return o.contiguous(), d / torch.linalg.norm(d, dim=-1, keepdim=True)


@torch.no_grad()
def scene_occupancy(n_sub: int, cone: float, device) -> ref.Occupancy:
    """The occupancy grid of the scene's closed-form density: each cell's
    optical thickness over one cone step (NGP-space density x the step),
    the largest of n_sub^3 points spread over the cell, then the
    configuration's bitfield rule; every cell counts as seen."""
    levels = []
    off = (torch.arange(n_sub, dtype=torch.float32, device=device) + 0.5) / n_sub - 0.5
    sub = torch.stack(torch.meshgrid(off, off, off, indexing="ij"), -1).reshape(-1, 3)
    for level in range(ref.N_CASCADES):
        centers = ref.cell_centers(level, device).reshape(-1, 3)
        size = 2.0 ** level / ref.GRID
        best = torch.empty(centers.shape[0], device=device)
        for a in range(0, centers.shape[0], 1 << 16):
            pts = centers[a:a + (1 << 16), None, :] + sub[None] * size
            _, sigma = scenes.detail_field((pts - OFF) / SCALE)
            best[a:a + (1 << 16)] = sigma.amax(1)
        levels.append((best / SCALE * cone).reshape(ref.GRID, ref.GRID, ref.GRID))
    grid = torch.stack(levels)
    bits, mean = ref.bitfield(grid)
    return ref.Occupancy(grid, bits, mean)


def render_state(ctx) -> dict:
    """The state the render cell's program and reference both render from,
    made by the benchmark alone: tables and weights from the seed, the
    scene's occupancy grid."""
    mix = ctx.mix
    spec = ref.ngp_spec(ctx.config["run_net"])
    tables, weights = make_weights(spec, ctx.seed, ctx.device, mlp_dtype(ctx.config),
                                   mix["table_scale"], mix["density_gain"])
    occ = scene_occupancy(mix["occupancy_points"], spec.min_cone_stepsize, ctx.device)
    return {"spec": spec, "tables": tables, "weights": weights, "occ": occ}


def load_occupancy(trainer, occ: ref.Occupancy) -> None:
    st = trainer.state
    trainer.state = st._replace(occ=st.occ._replace(
        density_grid=occ.grid.clone(), bitfield=occ.bits.clone(),
        mean_density=occ.mean.clone().to(st.occ.mean_density.dtype)))


def run_render(ctx) -> dict:
    mix, device = ctx.mix, ctx.device
    state = render_state(ctx)
    spec = state["spec"]
    H, W, chunk = mix["H"], mix["W"], mix["chunk"]
    focal = mix["focal_factor"] * W
    views = render_views(mix, device)
    trainer, _, _ = build_program(ctx.config, device, torch.stack(views), focal, W, H)
    load_params(trainer, state["tables"], state["weights"])
    load_occupancy(trainer, state["occ"])
    dtype = "bf16" if ctx.config["run_net"].get("fp16") else "f32"
    intr = torch.tensor([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]], device=device)
    traced = [False]

    def frame(v):
        with span("frame", traced[0]):
            return trainer.render_image(views[v], intr, H, W, chunk=chunk)

    frame(0)
    settle()
    setup_end = time.perf_counter()
    calls = CallLog(trainer.model)
    trace = Trace() if ctx.trace else None
    if trace is not None:
        calls.on()
        traced[0] = True
        trace.start()
        for i in range(mix["trace_frames"]):
            frame(i % len(views))
        trace.stop()
        traced[0] = False
        calls.off()
    lat, last, finite = [], {}, []
    i = 0
    t0 = time.perf_counter()
    while True:
        v = i % len(views)
        t = time.perf_counter()
        rgb, _ = frame(v)
        sync()
        lat.append(time.perf_counter() - t)
        last[v] = rgb
        finite.append(torch.isfinite(rgb).all())
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    out = {"setup_s": setup_end - ctx.t0, "attempted": i,
           "failed": int((~torch.stack(finite)).sum()), "window_s": window_s,
           "e2e": {"render_rays_per_s": i * H * W / window_s,
                   "frame_ms_p90": 1e3 * float(np.percentile(lat, 90))},
           "work": {"frames": i, "frame_ms_median": 1e3 * float(np.median(lat))},
           "memory_peak_bytes": ctx.memory_peak()}
    del trainer, frame
    ctx.free()
    if trace is not None:
        valid = [ref_valid_samples(spec, state["occ"], *view_rays(views[v], H, W, focal))
                 for v in range(len(views))]
        flops = field_flops(spec) * sum(valid[k % len(views)] for k in range(i))
        r = Readings(ctx.root, "render", trace, mix["trace_frames"], spec, dtype,
                     calls.records())
        r.mfu_pct = 100.0 * flops / (window_s * work.peak_flops(dtype))
        out["readings"] = r
    rng = np.random.default_rng(ctx.seed)
    picks = sorted(rng.choice(sorted(last), size=min(mix["check_views"], len(last)),
                              replace=False).tolist())
    out["checks"] = check_render(spec, state, {v: last[v] for v in picks}, views, H, W,
                                 focal, ctx.limits, "f32")
    return out


@torch.no_grad()
def ref_valid_samples(spec, occ, rays_o, rays_d, chunk: int = 65536) -> int:
    """The render march's valid samples of one frame, by the reference march."""
    return int(sum(ref.march(spec, occ, rays_o[a:a + chunk], rays_d[a:a + chunk],
                             spec.n_samples, None).valid.sum()
                   for a in range(0, rays_o.shape[0], chunk)))


def render_rmse(spec, state, frames: Dict[int, torch.Tensor], views, H, W, focal,
                quant: str) -> float:
    """The worst frame's root-mean-square difference from the reference's
    render of the same view from the same state."""
    field = ref.Field(spec, state["tables"], state["weights"], quant)
    worst = 0.0
    for v, rgb in frames.items():
        o, d = view_rays(views[v], H, W, focal)
        want = ref.render_frame(spec, field, state["occ"], o, d)
        worst = max(worst, float(torch.sqrt(((rgb.reshape(-1, 3).float() - want) ** 2).mean())))
    return worst


def check_render(spec, state, frames, views, H, W, focal, limits, quant):
    return [("frame_rmse", render_rmse(spec, state, frames, views, H, W, focal, quant),
             limits["frame_rmse"])]


def shortest(mix: dict) -> dict:
    """Mix overrides of the shortest run that still checks: one block of
    warm steps (with ``--seconds 0``, one more block, or one frame)."""
    return {"warm_steps": 16} if mix["mode"] == "train" else {}


def control(ctx, side: str) -> Dict[str, float]:
    """The numbers the check compares, with the reference in the program's
    place: computed in float8 e4m3 (side "control"), or, in a train cell,
    on the first half of each batch, the mean taken over it (side "half")."""
    mix, dev = ctx.mix, ctx.device
    if mix["mode"] == "render":
        if side != "control":
            raise ValueError(f"a render cell has no {side!r} side")
        state = render_state(ctx)
        spec, views = state["spec"], render_views(mix, dev)
        H, W, focal = mix["H"], mix["W"], mix["focal_factor"] * mix["W"]
        field = ref.Field(spec, state["tables"], state["weights"], "fp8")
        frames = {v: ref.render_frame(spec, field, state["occ"], *view_rays(views[v], H, W, focal))
                  for v in range(min(mix["check_views"], len(views)))}
        return {"frame_rmse": render_rmse(spec, state, frames, views, H, W, focal, "f32")}
    trainer, tcfg, data, spec, tables, weights = build(ctx.config, ctx.seed, dev)
    B = tcfg.n_rays_per_batch
    del trainer
    batches = [(ids // data.n_pixels, ids % data.n_pixels)
               for ids in first_ids(data.n_images * data.n_pixels, B, 3)]
    cams = data.cameras()
    occ0 = ref.initial_occupancy(cams, torch.full((cams.shape[0], 2), data.focal, device=dev),
                                 data.W, data.H)
    draws, inputs = first_inputs(spec, data, batches, ctx.seed, dev)
    want = ref.train_steps(spec, tables, weights, occ0, draws, inputs, "f32")
    if side == "half":
        half = [tuple(t[:t.shape[0] // 2] for t in b) for b in inputs]
        got = ref.train_steps(spec, tables, weights, occ0, draws, half, "f32")
    else:
        got = ref.train_steps(spec, tables, weights, occ0, draws, inputs, "fp8")
    return train_gaps({"loss": got.losses, "grad": got.grad_norms,
                       "change": got.change_norms}, want)


MODES = {"train": run_train, "render": run_render}


def run(ctx) -> dict:
    return MODES[ctx.mix["mode"]](ctx)

