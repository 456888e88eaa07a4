"""Convert the JAX package's model trees (as numpy arrays) into the port's
state and back, for an NGPModel or an OriginNeRFModel.

- NGP params: ``{"table": tables, "mlp": {"params": {"density0": {"kernel":
  [in, out]}, ...}}}`` where tables is the per-group list ('brick3'; a
  checkpoint stores it as a dict keyed "0", "1", ...) or the single
  [n_params, F] array ('hash');
- OriginNeRF params: ``{"mlp": {"params": {"pts_0": {"bias": [out],
  "kernel": [in, out]}, ..., "views_0", "feature", "alpha", "rgb"}}}``;
- the optax.adam state: ``({"count", "mu", "nu"}, {"count"})``, mu and nu
  shaped like params (a checkpoint keys the tuple "0", "1");
- ``OccupancyState``: density_grid, bitfield, mean_density, ema_step.

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
    if isinstance(model, OriginNeRFModel):
        layers: Dict[str, Dict[str, Any]] = {}
        for (layer, kind), leaf in zip(model.leaf_names(), leaves):
            layers.setdefault(layer, {})[kind] = leaf
        return {"mlp": {"params": layers}}
    n = len(model.tables)
    tables = list(leaves[:n])
    return {"table": tables if model.cfg.grid_impl != "hash" else tables[0],
            "mlp": {"params": {name: {"kernel": leaf}
                               for name, leaf in zip(MLP_LAYERS, leaves[n:])}}}


def param_leaves(model, tree: Dict[str, Any]) -> List[Any]:
    """A JAX params tree -> its leaves in param_list() order."""
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
load_ngp_params = load_ori_nerf_params = load_params
ngp_params_to_numpy = ori_nerf_params_to_numpy = params_to_numpy


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


def occupancy_from_numpy(tree: Dict[str, Any], device=None) -> OccupancyState:
    return OccupancyState(
        density_grid=_tensor(tree["density_grid"]).to(device, torch.float32),
        bitfield=_tensor(tree["bitfield"]).to(device, torch.bool),
        mean_density=_tensor(tree["mean_density"]).to(device, torch.float32),
        ema_step=_tensor(tree["ema_step"]).to(device, torch.int32))


def occupancy_to_numpy(state: OccupancyState) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in state._asdict().items()}
