"""Multi-rank train and render programs on a parallel/mesh.Mesh
(counterpart of myc_nerfs_tpu/parallel/spmd.py).

The JAX package places the state and the batch with NamedShardings and
lets GSPMD partition its one-chip programs. Here each rank runs the
one-process program on its shard and the collectives are explicit:

- NGP: rays over "data" (``NGPTrainer(mesh=...)`` averages the gradients
  and the metrics), tables replicated or, with ``GroupTPModel``, the
  hashed brick3 group tables split over "model";
- TensoRF: rays over "data", factor grids and MLP replicated;
- BARF/GARF: images over "data"; each rank refines its own cameras.

Every function takes its draws (rays, targets, march jitter; TensoRF's
sample jitter; the NeRF step's ``StepDraws``) for the global batch and
slices them per rank, so a run on any mesh, and one process over the whole
batch (``mesh.single_mesh``), consume the same numbers.

Not ported, for the reasons ROADMAP gives: ``LevelTPModel`` and the
``'levels'`` table mode (they coerce the grid to the per-level ``'brick'``
layout, which the port does not carry) and the ``'rows'`` mode (each
table's rows split over "model", so that every gather crosses cards; the
JAX package's ``'groups'`` mode superseded it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.ngp import HashGridConfig, NGPModel, NGPModelConfig
from ..ops import brick_grid as bg
from ..render import occupancy as occ
from ..render.ngp_render import NGPRenderConfig, NGPRenderOut, render_rays_ngp
from ..train import ngp_trainer
from ..train.ngp_trainer import AdamState
from ..utils.metrics import mse2psnr
from . import mesh as mesh_lib

NOT_PORTED = {
    "rows": "table_mode 'rows' (each table's rows split over \"model\": every "
            "gather crosses cards) is not ported; use 'groups' (ROADMAP)",
    "levels": "table_mode 'levels' (LevelTPModel) coerces the grid to the per-level "
              "'brick' layout, which the port does not carry; use 'groups' (ROADMAP)",
}


def _tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
    return a.to(device, dtype)


def _broadcast_into(mesh, tensors: Sequence[torch.Tensor], axis: str) -> None:
    """Copy the ``axis`` root's values into ``tensors`` in place."""
    for t, v in zip(tensors, mesh_lib.broadcast(mesh, list(tensors), axis)):
        with torch.no_grad():
            t.copy_(v)


# ---------------------------------------------------------------------------
# group tensor parallelism
# ---------------------------------------------------------------------------


class _GatherColumns(torch.autograd.Function):
    """Forward: every model-rank's feature columns, side by side, on every
    rank of the model group (a sum over a zero-filled buffer). Backward:
    this rank's columns of the output gradient (every rank of the group
    computes the rest of the step on the same full features)."""

    @staticmethod
    def forward(ctx, local, mesh, lo, total):
        ctx.cols = (lo, lo + local.shape[1])
        full = torch.zeros((local.shape[0], total), dtype=torch.float32,
                           device=local.device)
        full[:, lo:lo + local.shape[1]] = local
        if full.numel():
            (full,) = mesh_lib.all_reduce_sum(mesh, [full], "model")
        return full.to(local.dtype)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.cols
        return g[:, lo:hi], None, None, None


def restrict_geometry(cfg: HashGridConfig, levels: bg.BrickLevels, groups: bg.LevelGroups,
                      keep: Sequence[int]):
    """(cfg, BrickLevels, LevelGroups) of the groups ``keep`` (indices into
    groups.groups, in order) alone: their member levels renumbered 0.. in
    that order, each with its own scale, bricks and rows. The brick_encode
    kernels and their plain versions take it as they take a whole grid, and
    compute each level as they would in the whole grid."""
    lvls = [lv for g in keep for lv in groups.groups[g]]
    at = {lv: i for i, lv in enumerate(lvls)}
    sub = bg.BrickLevels(scales=tuple(levels.scales[lv] for lv in lvls),
                         resolutions=tuple(levels.resolutions[lv] for lv in lvls),
                         brick_dims=tuple(levels.brick_dims[lv] for lv in lvls),
                         dense=tuple(levels.dense[lv] for lv in lvls),
                         n_bricks=tuple(levels.n_bricks[lv] for lv in lvls),
                         bricks_per_level=levels.bricks_per_level, n_levels=len(lvls))
    sub_groups = bg.LevelGroups(groups=tuple(tuple(at[lv] for lv in groups.groups[g])
                                             for g in keep))
    return dataclasses.replace(cfg, n_levels=len(lvls)), sub, sub_groups


class GroupTPModel(NGPModel):
    """NGP with the hashed brick3 group tables split over the mesh's
    "model" axis (spmd.py:169 of the JAX package).

    Each model-rank holds len(hashed groups) / model whole group tables, in
    group order, as a list (no padding; core/bridge.py converts to and from
    the JAX package's stacked, zero-padded [G, rows, Wmax]), beside the
    replicated dense tables and MLPs. The encode runs the brick_encode
    kernels (their plain versions on the CPU) once on the dense and local
    groups, through a geometry restricted to them; an autograd function
    all-gathers the hashed features over the model group, and its backward
    keeps this rank's columns. The local tables' gradients are averaged
    over "data"; the dense tables' and the MLPs' over every rank (each
    model-rank computes them from the same features; averaging over all
    keeps the replicas equal where the encode backward's atomics add in
    another order on each rank).

    Built from the same generator as an NGPModel, it holds that model's
    tables and weights.
    """

    def __init__(self, cfg: NGPModelConfig, mesh, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.grid_impl != "brick3":
            cfg = dataclasses.replace(cfg, grid_impl="brick3")
        super().__init__(cfg, device=device, generator=generator)
        self.mesh = mesh
        lv, groups = self.levels, self.groups.groups
        self.dense_groups = [i for i, g in enumerate(groups) if lv.dense[g[-1]]]
        self.hashed_groups = [i for i, g in enumerate(groups) if not lv.dense[g[-1]]]
        if not self.hashed_groups:
            raise ValueError("the grid has no hashed groups to split")
        if any(len(groups[i]) != 1 for i in self.dense_groups) or \
                self.dense_groups != list(range(len(self.dense_groups))) or \
                [groups[i][0] for i in self.dense_groups] != self.dense_groups:
            raise ValueError("dense levels must be single groups, the coarse prefix")
        nm = mesh.model
        if len(self.hashed_groups) % nm:
            raise ValueError(f"{len(self.hashed_groups)} hashed groups do not split over "
                             f"model={nm}")
        if len({lv.n_bricks[groups[i][-1]] for i in self.hashed_groups}) != 1:
            raise ValueError("hashed groups must share one row budget")
        k = len(self.hashed_groups) // nm
        owned = [self.hashed_groups[r * k:(r + 1) * k] for r in range(nm)]
        self.local_groups = owned[mesh.model_index]
        self.held = self.dense_groups + self.local_groups  # full-grid index of each table
        full = list(self.tables)
        self.tables = nn.ParameterList([full[i] for i in self.held])
        self.local_geometry = restrict_geometry(cfg.grid, lv, self.groups, self.held)
        F = cfg.grid.n_features
        self.n_dense_cols = len(self.dense_groups) * F
        widths = [sum(len(groups[i]) for i in o) * F for o in owned]
        self.col_lo = sum(widths[:mesh.model_index])
        self.n_hashed_cols = sum(widths)
        # the gathered columns come in group order; the encode's output is in
        # level order (the JAX package's _col_map): the same order for the
        # groups compute_level_groups makes, permuted otherwise
        order = [lvl for i in self.hashed_groups for lvl in groups[i]]
        cols = [j * F + f for j in np.argsort(order, kind="stable") for f in range(F)]
        self.col_map = None if cols == list(range(len(cols))) else torch.tensor(cols)

    def grad_axes(self) -> List[str]:
        """The mesh axis each parameter's gradient is averaged over."""
        return (["world"] * len(self.dense_groups) + ["data"] * len(self.local_groups)
                + ["world"] * len(self.net.LAYERS))

    def encode(self, positions: torch.Tensor) -> torch.Tensor:
        shape = positions.shape[:-1]
        pos = positions.reshape(-1, 3)
        encode = bg.paired_encode if self.use_encode_kernel else bg.paired_encode_reference
        local = encode(list(self.tables), pos, *self.local_geometry,
                       compute_dtype=self.compute_dtype)
        nd = self.n_dense_cols
        hashed = _GatherColumns.apply(local[:, nd:], self.mesh, self.col_lo,
                                      self.n_hashed_cols)
        if self.col_map is not None:
            hashed = hashed[:, self.col_map.to(hashed.device)]
        out = torch.cat([local[:, :nd], hashed], -1)
        return out.reshape(shape + (self.cfg.grid.out_dim,))

    def gathered_tables(self) -> List[torch.Tensor]:
        """Every group's table, in the whole grid's order, on every rank of
        the model group (the local tables gathered over "model"): the tables
        of the one-process brick3 model this one splits."""
        nd = len(self.dense_groups)
        local = dict(zip(self.local_groups, self.tables[nd:]))
        hashed = []
        for i in self.hashed_groups:
            t = local.get(i)
            members = self.groups.groups[i]
            hashed.append(t.detach().clone() if t is not None else torch.zeros(
                (self.levels.n_bricks[members[-1]],
                 len(members) * self.cfg.grid.n_features * bg.ROW_VERTS),
                device=self.tables[0].device))
        return ([t.detach() for t in self.tables[:nd]]
                + mesh_lib.all_reduce_sum(self.mesh, hashed, "model"))


class LevelTPModel:
    """Not ported: see NOT_PORTED["levels"]."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED["levels"])


# ---------------------------------------------------------------------------
# NGP
# ---------------------------------------------------------------------------


def place_ngp_state(mesh, state: ngp_trainer.NGPTrainState,
                    table_mode: str = "replicated") -> ngp_trainer.NGPTrainState:
    """Make the train state one program's across the mesh: every replicated
    parameter, Adam moment and the occupancy grid take rank 0's values
    ('replicated', and the dense tables and MLPs of 'groups'); a
    GroupTPModel's local tables and moments take those of the rank at data
    index 0 of their data group ('groups'). The model's parameters are
    written in place. 'rows' and 'levels' raise (NOT_PORTED)."""
    if table_mode in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[table_mode])
    if table_mode not in ("replicated", "groups"):
        raise ValueError(f"table_mode {table_mode!r}")
    model = state.params
    if (table_mode == "groups") != isinstance(model, GroupTPModel):
        raise ValueError(f"table_mode {table_mode!r} with a {type(model).__name__}")
    params = model.param_list()
    axes = model.grad_axes() if table_mode == "groups" else ["world"] * len(params)
    opt = state.opt_state
    mu, nu = list(opt.mu), list(opt.nu)
    for axis in ("world", "data"):
        idx = [i for i, a in enumerate(axes) if a == axis]
        if not idx:
            continue
        _broadcast_into(mesh, [params[i] for i in idx], axis)
        moments = mesh_lib.broadcast(mesh, [mu[i] for i in idx] + [nu[i] for i in idx], axis)
        for j, i in enumerate(idx):
            mu[i], nu[i] = moments[j], moments[len(idx) + j]
    (count,) = mesh_lib.replicated(mesh, [opt.count])
    grid = occ.OccupancyState(*mesh_lib.replicated(mesh, list(state.occ)))
    return state._replace(opt_state=AdamState(count=count, mu=mu, nu=nu), occ=grid)


def occupancy_on(state: occ.OccupancyState) -> occ.OccupancyState:
    """Every cell occupied at density 0.05, so the march and the MLPs run
    (the JAX functions' ``occ_on``)."""
    return state._replace(bitfield=torch.ones_like(state.bitfield),
                          density_grid=torch.full_like(state.density_grid, 0.05),
                          mean_density=torch.full_like(state.mean_density, 0.05))


def block_model_cfg(table_mode: str) -> NGPModelConfig:
    """multichip_ngp_train_block's grid (the JAX function's): with 'groups'
    1 dense + 6 hashed levels, two brick3 triple groups; else 4 levels."""
    if table_mode == "groups":
        return NGPModelConfig(grid=HashGridConfig(n_levels=7, log2_hashmap_size=14,
                                                  desired_resolution=512.0),
                              grid_impl="brick3")
    return NGPModelConfig(grid=HashGridConfig(n_levels=4, desired_resolution=64.0))


def default_train_cfg(n_rays: int) -> ngp_trainer.NGPTrainConfig:
    return ngp_trainer.NGPTrainConfig(n_rays_per_batch=n_rays, target_batch_size=1 << 10,
                                      n_grid_uniform=1 << 10, n_grid_nonuniform=0)


def ngp_trainer_on(mesh, model_cfg: NGPModelConfig, rcfg: NGPRenderConfig,
                   tcfg: ngp_trainer.NGPTrainConfig, seed: int = 0, params=None,
                   table_mode: str = "replicated") -> ngp_trainer.NGPTrainer:
    """An NGPTrainer on ``mesh`` with weights from a generator seeded
    ``seed`` on the mesh's device, or from ``params`` (a JAX-layout numpy
    tree: the one-process model's, or GroupTP's stacked tables), every
    cell occupied, and the state placed (place_ngp_state)."""
    from ..core import bridge

    if table_mode in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[table_mode])
    device = mesh.device
    gen = torch.Generator(device=device).manual_seed(seed)
    model = GroupTPModel(model_cfg, mesh, device, gen) if table_mode == "groups" else None
    trainer = ngp_trainer.NGPTrainer(model_cfg, rcfg, tcfg, gen, device=device, model=model,
                                     mesh=mesh)
    if params is not None:
        if table_mode == "groups":
            bridge.load_group_tp_params(trainer.model, params)
        else:
            bridge.load_params(trainer.model, params)
    trainer.state = place_ngp_state(mesh, trainer.state._replace(
        occ=occupancy_on(trainer.state.occ)), table_mode=table_mode)
    return trainer


def ring_rays(n_rays: int, seed: int = 1, device="cpu"):
    """(rays_o, rays_d, target) [n, 3]: rays from a circle of radius 1.4
    around the box's centre, looking at it, and uniform targets, drawn
    from a generator seeded ``seed`` (the JAX functions' ray shape)."""
    gen = torch.Generator().manual_seed(seed)
    theta = torch.rand(n_rays, generator=gen) * 6.28318
    rays_o = torch.stack([0.5 + 1.4 * torch.cos(theta), 0.5 + 1.4 * torch.sin(theta),
                          torch.full((n_rays,), 0.5)], -1)
    rays_d = 0.5 - rays_o
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    target = torch.rand((n_rays, 3), generator=gen)
    return rays_o.to(device), rays_d.to(device), target.to(device)


def multichip_ngp_train_block(mesh, rays_o, rays_d, target, xi, table_mode: str = "replicated",
                              seed: int = 0, params=None,
                              model_cfg: Optional[NGPModelConfig] = None,
                              rcfg: Optional[NGPRenderConfig] = None,
                              tcfg: Optional[ngp_trainer.NGPTrainConfig] = None,
                              trainer: Optional[ngp_trainer.NGPTrainer] = None):
    """S = rays_o.shape[0] NGP steps on the mesh: rays_o / rays_d / target
    [S, B, 3] and the march jitter xi [S, B, 1] of the global batch, each
    rank taking its slice of B over "data". Grid (block_model_cfg), render
    (n_coarse 32, n_samples 8) and train config (default_train_cfg) are
    the JAX function's unless given; ``trainer`` continues an earlier
    block. Returns (trainer, metrics stacked over the S steps, each the
    global batch's)."""
    S, B = rays_o.shape[:2]
    if trainer is None:
        trainer = ngp_trainer_on(mesh, model_cfg or block_model_cfg(table_mode),
                                 rcfg or NGPRenderConfig(aabb_scale=1, n_coarse=32,
                                                         n_samples=8),
                                 tcfg or default_train_cfg(B), seed, params, table_mode)
    ro, rd, tg, x = (_tensor(a, mesh.device) for a in (rays_o, rays_d, target, xi))
    ro, rd, tg, x = mesh_lib.shard_batch(mesh, ro, rd, tg, x, axis=1)
    bg = torch.ones_like(ro)
    metrics = trainer.train_block(ro, rd, tg, bg=bg, xi=x)
    return trainer, metrics


def multichip_ngp_train_step(mesh, rays_o, rays_d, target, xi, table_mode: str = "replicated",
                             seed: int = 0, params=None,
                             model_cfg: Optional[NGPModelConfig] = None,
                             rcfg: Optional[NGPRenderConfig] = None,
                             tcfg: Optional[ngp_trainer.NGPTrainConfig] = None):
    """ONE NGP step on the mesh (the JAX function's defaults: a 4-level
    grid, n_coarse 32, n_samples 8): rays_o / rays_d / target [B, 3] and
    xi [B, 1] of the global batch. Returns (trainer, metrics of the step)."""
    model_cfg = model_cfg or NGPModelConfig(grid=HashGridConfig(n_levels=4,
                                                                desired_resolution=64.0))
    trainer, m = multichip_ngp_train_block(mesh, *(_tensor(a, mesh.device)[None]
                                                   for a in (rays_o, rays_d, target, xi)),
                                           table_mode=table_mode, seed=seed, params=params,
                                           model_cfg=model_cfg, rcfg=rcfg, tcfg=tcfg)
    return trainer, {k: v[0] for k, v in m.items()}


@torch.no_grad()
def multichip_ngp_render(mesh, occ_cfg: occ.OccupancyConfig, rcfg: NGPRenderConfig,
                         model: nn.Module, occ_state: occ.OccupancyState, rays_o, rays_d,
                         bg_color, placed: bool = False) -> NGPRenderOut:
    """Render a ray batch split over "data": each rank renders its slice
    and every rank gets the whole batch's rgb, depth and opacity (in ray
    order) and its sample count. Params and grid are first made rank 0's
    (replicated) unless ``placed`` (e.g. a GroupTPModel's split tables,
    whose model group renders the same slice)."""
    if not placed:
        _broadcast_into(mesh, model.param_list(), "world")
        occ_state = occ.OccupancyState(*mesh_lib.replicated(mesh, list(occ_state)))
    ro, rd = mesh_lib.shard_batch(mesh, _tensor(rays_o, mesh.device),
                                  _tensor(rays_d, mesh.device))
    bg = _tensor(bg_color, mesh.device)
    out = render_rays_ngp(occ_cfg, rcfg, model, occ_state, ro, rd, bg)
    (n,) = mesh_lib.all_reduce_sum(mesh, [out.n_samples], "data")
    return NGPRenderOut(rgb=mesh_lib.gather_rows(mesh, out.rgb),
                        depth=mesh_lib.gather_rows(mesh, out.depth),
                        opacity=mesh_lib.gather_rows(mesh, out.opacity), n_samples=n)


# ---------------------------------------------------------------------------
# TensoRF
# ---------------------------------------------------------------------------


def tensorf_block_configs(n_rays: int = 64, n_steps: int = 2):
    """The JAX function's toy parity shapes: (TensoRFConfig, TensoRFTrainConfig,
    aabb)."""
    from ..models import tensorf as tf_m
    from ..train import tensorf_trainer as tt

    mcfg = tf_m.TensoRFConfig(density_n_comp=(2, 2, 2), app_n_comp=(4, 4, 4), app_dim=8,
                              featureC=16, near_far=(1.5, 4.5), distance_scale=25.0,
                              density_shift=-5.0, shading_mode="MLP_Fea")
    tcfg = tt.TensoRFTrainConfig(n_iters=n_steps, batch_size=n_rays, n_voxel_init=8 ** 3,
                                 n_voxel_final=8 ** 3, upsamp_list=(),
                                 update_alphamask_list=(), n_samples_cap=16)
    return mcfg, tcfg, np.array([[-1.2, -1.2, -1.2], [1.2, 1.2, 1.2]])


def tensorf_block_batch(n_rays: int, n_steps: int, seed: int = 0):
    """The JAX function's batch shape from seeded generators: (rays [S, B,
    6] from a ray store of 4 orbit views, rgbs [S, B, 3] uniform, the
    sample jitter [S, B, 1])."""
    from ..data.synthetic import orbit_poses
    from ..train import tensorf_trainer as tt

    H = W = max(8, int(np.ceil(np.sqrt(n_steps * n_rays / 4.0))))
    f = 1.2 * W
    intr = torch.tensor([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]]).expand(4, 3, 3)
    store = tt.build_ray_store(orbit_poses(4), intr, H, W)
    gen = torch.Generator().manual_seed(seed + 1)
    ids = torch.randperm(store.shape[0], generator=gen)[:n_steps * n_rays]
    rays = store[ids].reshape(n_steps, n_rays, 6)
    rgbs = torch.rand((n_steps, n_rays, 3), generator=gen)
    jitter = torch.rand((n_steps, n_rays, 1), generator=gen)
    return rays, rgbs, jitter


def place_tensorf(mesh, trainer) -> None:
    """Rank 0's factor grids, MLP and buffers on every rank (in place)."""
    from ..models import tensorf as tf_m

    spatial, net = tf_m.group_leaves(trainer.params)
    _broadcast_into(mesh, spatial + net, "world")
    keys = [k for k, v in trainer.buffers.items() if torch.is_tensor(v)]
    for k, v in zip(keys, mesh_lib.replicated(mesh, [trainer.buffers[k] for k in keys])):
        trainer.buffers[k] = v


def multichip_tensorf_train_block(mesh, rays, rgbs, draws, mcfg=None, tcfg=None, aabb=None,
                                  seed: int = 0, params=None, on_step=None):
    """Ray-axis DP for TensoRF: S = rays.shape[0] steps on rays [S, B, 6],
    rgbs [S, B, 3] and the sample jitter [S, B, 1] of the global batch;
    each rank takes its slice of B over "data". Factor grids and MLP are
    replicated; ``TensoRFTrainer(mesh=...)`` averages both gradient groups
    over "data" before the two Adams. Configs default to
    tensorf_block_configs; ``params`` is a JAX-layout numpy tree;
    ``on_step(trainer)`` runs after every step. Returns (per-step metrics
    {"mse", "psnr"} [S], trainer)."""
    from ..core import bridge
    from ..train import tensorf_trainer as tt

    S, B = rays.shape[:2]
    d_mcfg, d_tcfg, d_aabb = tensorf_block_configs(B, S)
    trainer = tt.TensoRFTrainer(mcfg or d_mcfg, tcfg or d_tcfg,
                                d_aabb if aabb is None else aabb,
                                torch.Generator(device=mesh.device).manual_seed(seed),
                                device=mesh.device, mesh=mesh)
    if params is not None:
        trainer.params = bridge.load_tensorf_params(trainer.params, params)
        trainer._rebuild(1.0)
    place_tensorf(mesh, trainer)
    rays, rgbs, draws = (_tensor(a, mesh.device) for a in (rays, rgbs, draws))
    rays, rgbs, draws = mesh_lib.shard_batch(mesh, rays, rgbs, draws, axis=1)
    steps = []
    for s in range(S):
        steps.append(trainer.train_step(rays[s], rgbs[s], draws[s]))
        if on_step is not None:
            on_step(trainer)
    return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}, trainer


@torch.no_grad()
def multichip_tensorf_render(mesh, model_cfg, geom, params, buffers, rays,
                             white_bg: bool = True):
    """TensoRF's eval render with the rays split over "data" and rank 0's
    params and buffers on every rank (placed in place). Returns (rgb [N, 3],
    depth [N]) of the whole batch on every rank."""
    from ..models import tensorf as tf_m

    spatial, net = tf_m.group_leaves(params)
    _broadcast_into(mesh, spatial + net, "world")
    keys = [k for k, v in buffers.items() if torch.is_tensor(v)]
    buffers = dict(buffers)
    for k, v in zip(keys, mesh_lib.replicated(mesh, [buffers[k] for k in keys])):
        buffers[k] = v
    rays = mesh_lib.shard_batch(mesh, _tensor(rays, mesh.device))
    out = tf_m.tensorf_forward(model_cfg, geom, params, buffers, rays, None,
                               white_bg=white_bg)
    return mesh_lib.gather_rows(mesh, out.rgb_map), mesh_lib.gather_rows(mesh, out.depth_map)


# ---------------------------------------------------------------------------
# BARF / GARF
# ---------------------------------------------------------------------------


def _place_nerf_state(mesh, state, n_images: int):
    """Image-axis placement: the MLP, its Adam state and the step are rank
    0's on every rank; the per-image leaves (se3_refine, pose_noise and the
    pose Adam's moments, [n_images, 6]) are rank 0's rows of this rank's
    images."""
    params = state.params.param_list()
    _broadcast_into(mesh, params, "world")
    opt = state.opt_state
    moved = mesh_lib.replicated(mesh, [opt.count, *opt.mu, *opt.nu, state.step])
    n = len(opt.mu)
    opt = AdamState(count=moved[0], mu=moved[1:1 + n], nu=moved[1 + n:1 + 2 * n])
    pose = state.opt_state_pose
    se3, noise, pmu, pnu, pcount = mesh_lib.replicated(
        mesh, [state.se3_refine, state.pose_noise, pose.mu[0], pose.nu[0], pose.count])
    if se3.shape[0] != n_images:
        raise ValueError(f"{se3.shape[0]} pose rows for {n_images} images")
    se3, noise, pmu, pnu = mesh_lib.shard_batch(mesh, se3, noise, pmu, pnu)
    return state._replace(opt_state=opt, step=moved[-1], se3_refine=se3.contiguous(),
                          pose_noise=noise.contiguous(),
                          opt_state_pose=AdamState(count=pcount, mu=[pmu.contiguous()],
                                                   nu=[pnu.contiguous()]))


def slice_draws(mesh, draws):
    """This rank's images' rows of a step's global StepDraws (ray_idx is
    shared by every image)."""
    cut = {k: (None if v is None else mesh_lib.shard_batch(mesh, v))
           for k, v in draws._asdict().items() if k != "ray_idx"}
    return draws._replace(**cut)


def nerf_gradient_reduce(mesh, n_params: int):
    """make_train_step's hook: the MLP gradients averaged over every rank;
    this rank's se3_refine gradient divided by the data size, so that it
    is the gradient of the global batch's mean loss."""
    def reduce(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        out = mesh_lib.all_reduce_mean(mesh, grads[:n_params], "world")
        return out + [g / mesh.data for g in grads[n_params:]]
    return reduce


def multichip_nerf_train_block(mesh, cfg, state, images, poses, intr, draws: Sequence,
                               on_step=None):
    """Image-axis DP for BARF/GARF: images / poses / intrinsics and the
    per-image se(3) corrections split over "data" (each rank refines its
    own cameras; pose gradients never cross ranks), the MLP replicated and
    its gradients averaged. ``draws``: each step's global StepDraws (every
    rank slices its images' rows); ``on_step(state)`` runs after every
    step.
    Returns (this rank's state, per-step metrics {"loss", "psnr"} [S] of
    the global batch)."""
    from ..train import nerf_trainer as nt

    n_images = images.shape[0]
    state = _place_nerf_state(mesh, state, n_images)
    images, poses, intr = mesh_lib.shard_batch(mesh, images, poses, intr)
    step = nt.make_train_step(cfg, images, poses, intr, reduce_grads=nerf_gradient_reduce(
        mesh, len(state.params.param_list())))
    losses = []
    for d in draws:
        state, m = step(state, slice_draws(mesh, d))
        losses.append(mesh_lib.all_reduce_mean(mesh, [m["loss"]], "world")[0])
        if on_step is not None:
            on_step(state)
    loss = torch.stack(losses)
    return state, {"loss": loss, "psnr": mse2psnr(loss)}
