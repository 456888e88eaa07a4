"""Per-rank programs for mesh.spawn: each runs one spmd program on the
rank's mesh from numpy inputs and returns numpy results, so that a caller
(the tests, cli/multichip.py, chip_smoke.py) holds every rank's outcome
against one process over the whole batch, and against the JAX package.

Each returns, beside its outputs, the rank's place in the mesh, a checksum
per step of the parameters every rank must hold bit for bit
(``replicated``) and of the parameters its data group must (``local``:
GroupTP's hashed tables, the NeRF trainer's per-image pose rows), and the
kernel wrappers' launch counts of the run.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from . import mesh as mesh_lib
from . import spmd
from ..utils import profiling

KERNEL_COUNTERS = ("fused_mlp", "fused_mlp_bwd", "brick_encode", "brick_encode_bwd",
                   "march_rays_fused", "rgb_input", "ngp_composite", "ngp_composite_bwd")


def prebuild(device) -> None:
    """Build the kernels in this process before ranks are spawned, so that
    each rank only loads them (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        from ..ops.cuda import _build

        _build.build_all()


def reset_launches() -> None:
    profiling.reset()


def read_launches(device) -> Dict[str, int]:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    counts = profiling.counts(traced=False)
    return {k: counts[f"launch.{k}"] for k in KERNEL_COUNTERS}


def checksum(tensors: Sequence[torch.Tensor]) -> int:
    """A positional checksum of the tensors' bits: two lists of tensors that
    differ in any element's bits give different sums."""
    total = 0
    for t in tensors:
        t = t.detach().contiguous()
        bits = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).view(-1)
        bits = bits.view(torch.int32).to(torch.int64) if bits.element_size() == 4 \
            else bits.to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        total = (total * 1000003 + int((bits * w).sum())) % (1 << 61)
    return total


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _StepClock:
    """Seconds between calls of tick() (synchronised), from construction."""

    def __init__(self, device):
        self.device = device
        _sync(device)
        self.last, self.times = time.perf_counter(), []

    def tick(self) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.times.append(now - self.last)
        self.last = now


def _place(mesh) -> dict:
    return {"rank": mesh.rank, "data_index": mesh.data_index, "model_index": mesh.model_index,
            "shape": mesh.shape, "backend": mesh.backend, "device": str(mesh.device)}


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def mesh_probe(mesh, batch: np.ndarray, w: np.ndarray) -> dict:
    """The rank's place, its shard of ``batch``, and the gradient of the
    mean loss mean((x @ w)^2) over the data-sharded batch (averaged over
    "data"), with rows gathered back in order."""
    x = torch.from_numpy(batch)
    shard = mesh_lib.shard_batch(mesh, x)
    wt = torch.from_numpy(w).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.mean((shard @ wt) ** 2), [wt])
    (g,) = mesh_lib.all_reduce_mean(mesh, [g], "data")
    return {**_place(mesh), "shard": shard.numpy(), "grad": g.numpy(),
            "gathered": mesh_lib.gather_rows(mesh, shard).numpy(),
            "gathered_world": mesh_lib.gather_rows(mesh, torch.full((1,), float(mesh.rank)),
                                                   "world").numpy()}


def fail_on(mesh, rank: int) -> int:
    """Raise on ``rank`` (the launcher's failure path)."""
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    return mesh.rank


def sleep_on(mesh, rank: int, seconds: float) -> int:
    """Sleep on ``rank`` (the launcher's time limit)."""
    if mesh.rank == rank:
        time.sleep(seconds)
    return mesh.rank


# ---------------------------------------------------------------------------
# NGP
# ---------------------------------------------------------------------------


def _ngp_params_numpy(model) -> Dict[str, Any]:
    """The one-process brick3 (or hash) model's params tree of ``model``
    (GroupTP tables gathered over "model")."""
    from ..core import bridge

    if isinstance(model, spmd.GroupTPModel):
        return bridge.group_tp_to_brick3(bridge.group_tp_params_to_numpy(model), model)
    return bridge.params_to_numpy(model)


def _ngp_checksums(model) -> dict:
    if isinstance(model, spmd.GroupTPModel):
        nd = len(model.dense_groups)
        tabs = list(model.tables)
        return {"replicated": checksum(tabs[:nd] + [getattr(model.net, n)
                                                    for n in model.net.LAYERS]),
                "local": checksum(tabs[nd:])}
    return {"replicated": checksum(model.param_list()), "local": 0}


def ngp_block(mesh, spec: dict) -> dict:
    """spmd.multichip_ngp_train_block one step at a time on spec's rays_o /
    rays_d / target [S, B, 3] and xi [S, B, 1] (table_mode, seed, params,
    model_cfg, rcfg, tcfg as the function takes them), with a checksum of
    the parameters after every step and of the occupancy grid after an
    update (spec["grid_update"]: run one after the block from a generator
    seeded 5); spec["adapt"] runs the batch adaptation after the block.
    S may be 0 (the placed state alone). With spec["render"] = (rcfg, rays_o, rays_d), the trained
    model then renders them with multichip_ngp_render. Returns the per-step
    metrics, the params (one-process layout), checksums, launches, times."""
    S = spec["rays_o"].shape[0]
    table_mode = spec.get("table_mode", "replicated")
    trainer = spmd.ngp_trainer_on(
        mesh, spec.get("model_cfg") or spmd.block_model_cfg(table_mode),
        spec.get("rcfg") or spmd.NGPRenderConfig(aabb_scale=1, n_coarse=32, n_samples=8),
        spec.get("tcfg") or spmd.default_train_cfg(spec["rays_o"].shape[1]),
        spec.get("seed", 0), spec.get("params"), table_mode)
    reset_launches()
    _sync(mesh.device)
    t0 = time.perf_counter()
    out = {"loss": [], "psnr": [], "n_samples": [], "checksums": [], "step_s": []}
    for s in range(S):
        t_step = time.perf_counter()
        trainer, m = spmd.multichip_ngp_train_block(
            mesh, *(spec[k][s:s + 1] for k in ("rays_o", "rays_d", "target", "xi")),
            trainer=trainer)
        out["loss"].append(float(m["loss"][0]))
        out["psnr"].append(float(m["psnr"][0]))
        out["n_samples"].append(int(m["n_samples"][0]))
        out["step_s"].append(time.perf_counter() - t_step)  # the loss read synced
        out["checksums"].append(_ngp_checksums(trainer.model))
    _sync(mesh.device)
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = read_launches(mesh.device)
    if spec.get("adapt"):
        trainer._update_batch_rays()
    model = trainer.model
    if spec.get("grid_update"):
        # no collective: each rank draws the same samples and evaluates
        # the same model, so its grid must come out rank 0's on its own
        trainer.state = trainer.state._replace(occ=trainer.grid_update(
            trainer.state.occ, torch.Generator(device=mesh.device).manual_seed(5)))
        out["grid_checksum"] = checksum(list(trainer.state.occ)[:3])
    if spec.get("render") is not None:
        rcfg, ro, rd = spec["render"]
        reset_launches()
        _sync(mesh.device)
        t1 = time.perf_counter()
        r = spmd.multichip_ngp_render(mesh, trainer.occ_cfg, rcfg, model, trainer.state.occ,
                                      ro, rd, torch.ones(3), placed=True)
        _sync(mesh.device)
        out["render"] = {"rgb": _numpy(r.rgb), "depth": _numpy(r.depth),
                         "n_samples": int(r.n_samples), "s": time.perf_counter() - t1,
                         "launches": read_launches(mesh.device)}
    out["params"] = _ngp_params_numpy(model)
    out["occ"] = {k: v.detach().cpu().numpy() for k, v in trainer.state.occ._asdict().items()}
    out["n_rays_per_batch"] = trainer.n_rays_per_batch
    return {**_place(mesh), **out}


def group_tp_encode(mesh, spec: dict) -> dict:
    """A GroupTPModel (spec's model_cfg and JAX-layout params) applied to
    spec's positions and dirs [N, 3] (every rank the same), and the
    gradient of the sum of its outputs: the outputs, the dense and MLP
    gradients and this rank's hashed-group gradients (by group index)."""
    from ..core import bridge

    model = spmd.GroupTPModel(spec["model_cfg"], mesh, device=mesh.device)
    bridge.load_group_tp_params(model, spec["params"])
    model.use_encode_kernel = spec.get("kernels", True)
    pos = torch.from_numpy(spec["pos"]).to(mesh.device)
    dirs = torch.from_numpy(spec["dirs"]).to(mesh.device)
    params = model.param_list()
    with torch.enable_grad():
        out = model(pos, dirs)
        grads = torch.autograd.grad(out.sum(), params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    nd, nl = len(model.dense_groups), len(model.local_groups)
    return {**_place(mesh), "out": _numpy(out),
            "dense": [_numpy(g) for g in grads[:nd]],
            "hashed": {i: _numpy(g) for i, g in zip(model.local_groups, grads[nd:nd + nl])},
            "mlp": [_numpy(g) for g in grads[nd + nl:]]}


# ---------------------------------------------------------------------------
# TensoRF and BARF/GARF
# ---------------------------------------------------------------------------


def tensorf_block(mesh, spec: dict) -> dict:
    """spmd.multichip_tensorf_train_block on spec's rays / rgbs / draws
    (mcfg, tcfg, aabb, seed, params as it takes them), a
    checksum of the params after every step, and with spec["render"]
    (rays [N, 6]) multichip_tensorf_render of the trained params."""
    from ..core import bridge
    from ..models import tensorf as tf_m

    sums, step_s = [], _StepClock(mesh.device)

    def on_step(tr):
        step_s.tick()
        sums.append({"replicated": checksum(sum(tf_m.group_leaves(tr.params), [])),
                     "local": 0})

    metrics, trainer = spmd.multichip_tensorf_train_block(
        mesh, spec["rays"], spec["rgbs"], spec["draws"], mcfg=spec.get("mcfg"),
        tcfg=spec.get("tcfg"), aabb=spec.get("aabb"), seed=spec.get("seed", 0),
        params=spec.get("params"), on_step=on_step)
    out = {"mse": [float(v) for v in metrics["mse"]], "checksums": sums,
           "train_s": sum(step_s.times), "step_s": step_s.times,
           "params": bridge.tensorf_params_tree(trainer.params)}
    if spec.get("render") is not None:
        t1 = time.perf_counter()
        rgb, depth = spmd.multichip_tensorf_render(
            mesh, trainer.model_cfg, trainer.geom, trainer.params, trainer.buffers,
            spec["render"], white_bg=trainer.cfg.white_bg)
        _sync(mesh.device)
        out["render"] = {"rgb": _numpy(rgb), "depth": _numpy(depth),
                         "s": time.perf_counter() - t1}
    return {**_place(mesh), **out}


def tensorf_train(mesh, spec: dict) -> dict:
    """TensoRFTrainer(mesh=...).train on spec's dataset (all_rays [N, 6],
    all_rgbs [N, 3]) for spec["n_iters"] steps, the jitter of step ``it``
    spec["draws"][it] [batch, 1] for the global batch (the sampler draws
    global ids; each rank slices its rows), from spec's params, the rank-0
    state placed. Returns the last step's mse and the params."""
    from ..core import bridge
    from ..train import tensorf_trainer as tt

    dev = mesh.device
    trainer = tt.TensoRFTrainer(spec["mcfg"], spec["tcfg"], spec["aabb"],
                                torch.Generator(device=dev).manual_seed(0), device=dev,
                                mesh=mesh if mesh.size > 1 else None)
    trainer.params = bridge.load_tensorf_params(trainer.params, spec["params"])
    trainer._rebuild(1.0)
    spmd.place_tensorf(mesh, trainer)
    rays, rgbs, draws = (torch.from_numpy(np.array(spec[k], np.float32)).to(dev)
                         for k in ("rays", "rgbs", "draws"))
    m = trainer.train(rays, rgbs, n_iters=spec["n_iters"], draws=lambda it: draws[it])
    return {**_place(mesh), "mse": float(m["mse"]),
            "params": bridge.tensorf_params_tree(trainer.params)}


def draws_to_numpy(draws) -> List[dict]:
    return [{k: (None if v is None else v.cpu().numpy()) for k, v in d._asdict().items()}
            for d in draws]


def draws_from_numpy(draws: Sequence[dict], device) -> list:
    from ..train import nerf_trainer as nt

    return [nt.StepDraws(**{k: (None if v is None else torch.from_numpy(np.array(v))
                                .to(device)) for k, v in d.items()}) for d in draws]


def nerf_block(mesh, spec: dict) -> dict:
    """spmd.multichip_nerf_train_block on spec's cfg, images / poses / intr
    and per-step draws (numpy dicts of StepDraws' fields); the initial
    state from a generator seeded spec["seed"] on the mesh's device, or
    spec's "params" (a JAX-layout tree) and "pose_noise". Returns the per-step
    loss, se3_refine gathered over "data", the MLP params and checksums."""
    from ..core import bridge
    from ..train import nerf_trainer as nt

    dev = mesh.device
    cfg = spec["cfg"]
    images, poses, intr = (torch.from_numpy(np.array(spec[k], np.float32)).to(dev)
                           for k in ("images", "poses", "intr"))
    state = nt.init_state(cfg, torch.Generator(device=dev).manual_seed(spec.get("seed", 0)),
                          images.shape[0], dev)
    if spec.get("params") is not None:
        bridge.load_params(state.params, spec["params"])
        state = state._replace(pose_noise=torch.from_numpy(spec["pose_noise"]).to(dev))
    sums, step_s = [], _StepClock(dev)

    def on_step(st):
        step_s.tick()
        sums.append({"replicated": checksum(st.params.param_list()),
                     "local": checksum([st.se3_refine])})

    state, metrics = spmd.multichip_nerf_train_block(
        mesh, cfg, state, images, poses, intr, draws_from_numpy(spec["draws"], dev),
        on_step=on_step)
    se3 = mesh_lib.gather_rows(mesh, state.se3_refine)
    return {**_place(mesh), "loss": [float(v) for v in metrics["loss"]],
            "se3_refine": _numpy(se3), "checksums": sums,
            "train_s": sum(step_s.times), "step_s": step_s.times,
            "params": bridge.params_to_numpy(state.params)}


LEG_FNS = {"ngp": ngp_block, "nerf": nerf_block, "tensorf": tensorf_block}


def run_legs(mesh, legs: Sequence) -> dict:
    """Run each (name, kind, model, spec) of ``legs`` (LEG_FNS[kind]) on a
    (size / model) x model mesh of these ranks, one after another. Every
    rank makes the meshes in one order. Returns {name: result}."""
    meshes = {mesh.model: mesh}
    out = {}
    for name, kind, model, spec in legs:
        if model not in meshes:
            meshes[model] = mesh_lib.make_mesh(model=model, device=mesh.device)
        out[name] = LEG_FNS[kind](meshes[model], spec)
    return out
