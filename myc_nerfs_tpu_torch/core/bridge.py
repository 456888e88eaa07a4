"""Convert the JAX package's model trees (as numpy arrays) into the port's
state and back, for an NGPModel, an OriginNeRFModel, a NeRFMLP, the
CoarseFine pair of fine sampling, and TensoRF's params and two Adams (at
the end of the file).

- NGP params: ``{"table": tables, "mlp": {"params": {"density0": {"kernel":
  [in, out]}, ...}}}`` where tables is the per-group list ('brick3'; a
  checkpoint stores it as a dict keyed "0", "1", ...) or the single
  [n_params, F] array ('hash');
- OriginNeRF params: ``{"mlp": {"params": {"pts_0": {"bias": [out],
  "kernel": [in, out]}, ..., "views_0", "feature", "alpha", "rgb"}}}``;
- NeRFMLP params: ``{"params": {"Dense_0": {"bias": [out], "kernel": [in,
  out]}, ...}}``, flax's compact-call order (feature layers, then rgb
  layers); CoarseFine: ``{"coarse": <NeRFMLP tree>, "fine": <NeRFMLP tree>}``;
- the optax.adam state: ``({"count", "mu", "nu"}, {"count"})``, mu and nu
  shaped like params (a checkpoint keys the tuple "0", "1"); for the pose
  corrections of the NeRF trainer, mu and nu are single [n_images, 6] arrays;
- ``OccupancyState``: density_grid, bitfield, mean_density, ema_step;
- GroupTP params (parallel/spmd.GroupTPModel): ``{"table": {"dense":
  [tables], "hashed": [G, rows, Wmax]}, "mlp": ...}``, the hashed group
  tables stacked and zero-padded on the width axis; the port holds each
  model-rank's groups as an unpadded list (``group_tp_unstack``,
  ``group_tp_stack``).

The port keeps parameters and moments as lists in the model's param_list()
order; ``param_tree`` and ``param_leaves`` convert between the two.

bf16 arrays may arrive as ml_dtypes bfloat16 or already widened to f32;
either way the copy into a bf16 tensor is exact. Going back, bf16 tensors
come out as f32 arrays holding the same values.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..models.nerf_mlp import CoarseFine, NeRFMLP
from ..models.ngp import NGPNetwork
from ..models.ori_nerf import OriginNeRFModel
from ..render.occupancy import OccupancyState
from ..train.ngp_trainer import AdamState

MLP_LAYERS = NGPNetwork.LAYERS


def _tensor(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _table_list(tables: Any) -> List[Any]:
    if isinstance(tables, dict):
        return [tables[str(i)] for i in range(len(tables))]
    if isinstance(tables, (list, tuple)):
        return list(tables)
    return [tables]


def param_tree(model, leaves: Sequence[Any]) -> Dict[str, Any]:
    """Leaves in param_list() order -> the JAX params tree layout."""
    if isinstance(model, CoarseFine):
        n = len(model.coarse.param_list())
        return {"coarse": param_tree(model.coarse, leaves[:n]),
                "fine": param_tree(model.fine, leaves[n:])}
    if isinstance(model, (OriginNeRFModel, NeRFMLP)):
        layers: Dict[str, Dict[str, Any]] = {}
        for (layer, kind), leaf in zip(model.leaf_names(), leaves):
            layers.setdefault(layer, {})[kind] = leaf
        return ({"params": layers} if isinstance(model, NeRFMLP)
                else {"mlp": {"params": layers}})
    n = len(model.tables)
    tables = list(leaves[:n])
    return {"table": tables if model.cfg.grid_impl != "hash" else tables[0],
            "mlp": {"params": {name: {"kernel": leaf}
                               for name, leaf in zip(MLP_LAYERS, leaves[n:])}}}


def param_leaves(model, tree: Dict[str, Any]) -> List[Any]:
    """A JAX params tree -> its leaves in param_list() order."""
    if isinstance(model, CoarseFine):
        if "coarse" not in tree:
            raise ValueError("a params tree without fine sampling for a CoarseFine model")
        return param_leaves(model.coarse, tree["coarse"]) + param_leaves(model.fine,
                                                                         tree["fine"])
    if isinstance(model, NeRFMLP):
        if "params" not in tree:
            raise ValueError("not a NeRFMLP params tree (fine sampling's coarse/fine pair?)")
        layers = tree["params"]
        if len(layers) != len(model.kernels):
            raise ValueError(f"{len(layers)} layers for a NeRFMLP with {len(model.kernels)}")
        return [layers[layer][kind] for layer, kind in model.leaf_names()]
    if isinstance(model, OriginNeRFModel):
        if "table" in tree:
            raise ValueError("an NGP params tree for an OriginNeRF model")
        layers = tree["mlp"]["params"]
        return [layers[layer][kind] for layer, kind in model.leaf_names()]
    if "table" not in tree:
        raise ValueError("an OriginNeRF params tree for an NGP model")
    tables = _table_list(tree["table"])
    if len(tables) != len(model.tables):
        raise ValueError(f"{len(tables)} tables for a model with "
                         f"{len(model.tables)} (grid_impl mismatch?)")
    mlp = tree["mlp"]["params"]
    return tables + [mlp[name]["kernel"] for name in MLP_LAYERS]


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} does not match the "
                         f"model's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def load_params(model, tree: Dict[str, Any]):
    """Copy a JAX params tree (NGPModel's or OriginNeRFModel's, as
    ``model`` is) into ``model`` (in place)."""
    for i, (dst, src) in enumerate(zip(model.param_list(), param_leaves(model, tree))):
        _copy(dst, src, f"param {i}")
    return model


def params_to_numpy(model) -> Dict[str, Any]:
    """The inverse of load_params, in the JAX tree layout."""
    return param_tree(model, [_numpy(p) for p in model.param_list()])


# by model family, as the tests and chip_smoke name them
load_ngp_params = load_ori_nerf_params = nerf_params_from_numpy = load_params
ngp_params_to_numpy = ori_nerf_params_to_numpy = nerf_params_to_numpy = params_to_numpy


def adam_from_numpy(model, opt_tree: Dict[str, Any]) -> AdamState:
    """A checkpoint's optax.adam state {"0": {"count", "mu", "nu"}, "1":
    {"count"}} -> AdamState on the model's device, moments in the params'
    dtypes."""
    adam = opt_tree["0"]
    params = model.param_list()

    def moments(tree):
        out = []
        for p, src in zip(params, param_leaves(model, tree)):
            t = torch.empty_like(p, requires_grad=False)
            _copy(t, src, "adam moment")
            out.append(t)
        return out

    return AdamState(count=_tensor(adam["count"]).to(params[0].device, torch.int32),
                     mu=moments(adam["mu"]), nu=moments(adam["nu"]))


def adam_tree(model, opt: AdamState) -> Dict[str, Any]:
    """AdamState -> the optax.adam state tree as a checkpoint stores it,
    {"0": {"count", "mu", "nu"}, "1": {"count"}}, with the port's tensors
    as leaves (optax's two step counts are the one count)."""
    return {"0": {"count": opt.count, "mu": param_tree(model, opt.mu),
                  "nu": param_tree(model, opt.nu)},
            "1": {"count": opt.count}}


def group_tp_stack(hashed: Sequence[Any]) -> np.ndarray:
    """The hashed group tables (numpy or tensors, in group order) as the
    JAX GroupTPModel stacks them: [G, rows, Wmax], each narrower group
    zero-padded on the right."""
    hashed = [_numpy(t) if torch.is_tensor(t) else np.asarray(t, np.float32) for t in hashed]
    wmax = max(t.shape[1] for t in hashed)
    return np.stack([np.pad(t, ((0, 0), (0, wmax - t.shape[1]))) for t in hashed])


def group_tp_unstack(stacked: Any, widths: Sequence[int]) -> List[np.ndarray]:
    """group_tp_stack's inverse: group g is stacked[g, :, :widths[g]]."""
    stacked = np.asarray(stacked)
    if stacked.dtype.name == "bfloat16":
        stacked = stacked.astype(np.float32)
    if stacked.shape[0] != len(widths):
        raise ValueError(f"{stacked.shape[0]} stacked groups for {len(widths)} widths")
    return [np.array(stacked[g, :, :w]) for g, w in enumerate(widths)]


def _group_widths(model, ids: Sequence[int]) -> List[int]:
    F = model.cfg.grid.n_features
    return [len(model.groups.groups[i]) * F * 128 for i in ids]


def load_group_tp_params(model, tree: Dict[str, Any]):
    """Copy a JAX GroupTPModel params tree into this rank's GroupTPModel
    (in place): the dense tables, this rank's hashed groups (their unpadded
    columns) and the MLP weights."""
    dense = _table_list(tree["table"]["dense"])
    hashed = group_tp_unstack(tree["table"]["hashed"],
                              _group_widths(model, model.hashed_groups))
    by_group = dict(zip(model.hashed_groups, hashed))
    srcs = list(dense) + [by_group[i] for i in model.local_groups]
    mlp = tree["mlp"]["params"]
    srcs += [mlp[name]["kernel"] for name in MLP_LAYERS]
    params = model.param_list()
    if len(srcs) != len(params):
        raise ValueError(f"{len(srcs)} leaves for a model with {len(params)}")
    for i, (dst, src) in enumerate(zip(params, srcs)):
        _copy(dst, src, f"param {i}")
    return model


def group_tp_params_to_numpy(model) -> Dict[str, Any]:
    """The JAX GroupTPModel params tree of a GroupTPModel, its hashed
    tables gathered over the model axis (every rank of the model group must
    call it)."""
    tables = model.gathered_tables()
    nd = len(model.dense_groups)
    return {"table": {"dense": [_numpy(t) for t in tables[:nd]],
                      "hashed": group_tp_stack(tables[nd:])},
            "mlp": {"params": {name: {"kernel": _numpy(getattr(model.net, name))}
                               for name in MLP_LAYERS}}}


def group_tp_to_brick3(tree: Dict[str, Any], model) -> Dict[str, Any]:
    """A JAX GroupTPModel params tree as the one-process brick3 model's
    (the dense tables, then every hashed group unpadded, in group order);
    ``model`` is either model (it supplies the grouping)."""
    from ..ops import brick_grid as bg

    levels = bg.compute_brick_levels(model.cfg.grid)
    groups = bg.compute_level_groups(levels, group_size=3).groups
    hashed_ids = [i for i, g in enumerate(groups) if not levels.dense[g[-1]]]
    F = model.cfg.grid.n_features
    hashed = group_tp_unstack(tree["table"]["hashed"],
                              [len(groups[i]) * F * 128 for i in hashed_ids])
    return {"table": list(_table_list(tree["table"]["dense"])) + hashed, "mlp": tree["mlp"]}


def occupancy_from_numpy(tree: Dict[str, Any], device=None) -> OccupancyState:
    return OccupancyState(
        density_grid=_tensor(tree["density_grid"]).to(device, torch.float32),
        bitfield=_tensor(tree["bitfield"]).to(device, torch.bool),
        mean_density=_tensor(tree["mean_density"]).to(device, torch.float32),
        ema_step=_tensor(tree["ema_step"]).to(device, torch.int32))


def occupancy_to_numpy(state: OccupancyState) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in state._asdict().items()}


def pose_adam_from_numpy(opt_tree: Dict[str, Any], like: torch.Tensor) -> AdamState:
    """The pose corrections' optax.adam state {"0": {"count", "mu", "nu"},
    "1": {"count"}} -> AdamState on ``like``'s device and dtype."""
    adam = opt_tree["0"]

    def moment(src):
        t = torch.empty_like(like)
        _copy(t, src, "pose adam moment")
        return t

    return AdamState(count=_tensor(adam["count"]).to(like.device, torch.int32),
                     mu=[moment(adam["mu"])], nu=[moment(adam["nu"])])


def pose_adam_tree(opt: AdamState) -> Dict[str, Any]:
    """The inverse of pose_adam_from_numpy, tensors as leaves."""
    return {"0": {"count": opt.count, "mu": opt.mu[0], "nu": opt.nu[0]},
            "1": {"count": opt.count}}


# -- TensoRF ------------------------------------------------------------------
# params as the JAX tree: {"density_plane": (3 arrays), ..., "basis_mat",
# "mlp": {"params": {"Dense_0": {"kernel", "bias"}, ...}}, "normal_linear":
# {"w", "b"}, "bg_net": {"params": {...}}}; a checkpoint keys the tuples "0",
# "1", "2". The optimizer is optax.multi_transform of two adams:
# {"inner_states": {"net"|"spatial": {"inner_state": {"0": {"count", "mu",
# "nu"}, "1": {"count"}}}}}, where mu and nu hold the group's params and an
# empty dict (optax's MaskedNode) at every other top-level key.


def tree_get(tree: Any, path: Sequence[str]) -> Any:
    """The leaf of a JAX or checkpoint tree at ``path`` (tuple entries by
    their index, checkpoint lists by their "0", "1", ... keys)."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def tree_from_items(items) -> Dict[str, Any]:
    """Nested dicts from (path, leaf) pairs, keys sorted at every level (the
    order of a flax checkpoint)."""
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def sort(node):
        return {k: sort(node[k]) for k in sorted(node)} if isinstance(node, dict) else node
    return sort(tree)


def tensorf_params_tree(params, leaf=_numpy) -> Dict[str, Any]:
    """TensoRF params -> the JAX tree (lists keyed "0", "1", "2"), leaves
    through ``leaf`` (numpy copies by default)."""
    from ..models.tensorf import param_items

    return tree_from_items((path, leaf(t)) for path, t in param_items(params))


def load_tensorf_params(params, tree: Dict[str, Any]):
    """A JAX (or checkpoint) TensoRF params tree into ``params``: new leaf
    tensors for the factor grids and the basis matrix (any shape: stages
    differ), the modules' parameters copied in place (shapes checked).
    Returns the new params dict."""
    from ..models.tensorf import param_items

    new = dict(params)
    for key, value in params.items():
        if isinstance(value, torch.nn.Module):
            continue
        like = value[0] if isinstance(value, (list, tuple)) else value
        conv = lambda a: _tensor(a).to(like.device, like.dtype).requires_grad_(True)  # noqa: E731
        if isinstance(value, (list, tuple)):
            new[key] = [conv(tree_get(tree, (key, str(i)))) for i in range(len(value))]
        else:
            new[key] = conv(tree[key])
    for path, p in param_items(params):
        if isinstance(params[path[0]], torch.nn.Module):
            _copy(p, tree_get(tree, path), "/".join(path))
    return new


def tensorf_adam_tree(params, spatial: AdamState, net: AdamState) -> Dict[str, Any]:
    """Both Adams -> the optax.multi_transform state tree, the port's tensors
    as leaves."""
    from ..models.tensorf import param_groups

    groups = dict(zip(("spatial", "net"), param_groups(params)))
    inner = {}
    for name, opt in (("net", net), ("spatial", spatial)):
        paths = groups[name]

        def moments(leaves):
            tree = tree_from_items(zip(paths, leaves))
            return {k: tree.get(k, {}) for k in sorted(params)}
        inner[name] = {"inner_state": {"0": {"count": opt.count, "mu": moments(opt.mu),
                                             "nu": moments(opt.nu)},
                                       "1": {"count": opt.count}}}
    return {"inner_states": inner}


def tensorf_adam_from_numpy(params, opt_tree: Dict[str, Any]):
    """The multi_transform state tree -> (spatial AdamState, net AdamState)
    on the params' device, moments shaped like the params."""
    from ..models.tensorf import param_groups, param_items

    tensors = dict(param_items(params))
    out = []
    for name, paths in zip(("spatial", "net"), param_groups(params)):
        adam = opt_tree["inner_states"][name]["inner_state"]
        adam = adam["0"] if isinstance(adam, dict) else adam[0]

        def moments(tree):
            res = []
            for path in paths:
                t = torch.empty_like(tensors[path], requires_grad=False)
                _copy(t, tree_get(tree, path), "adam moment " + "/".join(path))
                res.append(t)
            return res
        device = tensors[paths[0]].device if paths else None
        out.append(AdamState(count=_tensor(adam["count"]).to(device, torch.int32),
                             mu=moments(adam["mu"]), nu=moments(adam["nu"])))
    return tuple(out)
