"""Convert the JAX package's NGP trees (as numpy arrays) into the port's
state and back.

- params: ``{"table": tables, "mlp": {"params": {"density0": {"kernel":
  [in, out]}, ...}}}`` where tables is the per-group list ('brick3'; a
  checkpoint stores it as a dict keyed "0", "1", ...) or the single
  [n_params, F] array ('hash');
- ``OccupancyState``: density_grid, bitfield, mean_density, ema_step.

bf16 arrays may arrive as ml_dtypes bfloat16 or already widened to f32;
either way the copy into a bf16 tensor is exact. Going back, bf16 tensors
come out as f32 arrays holding the same values.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..models.ngp import NGPModel
from ..render.occupancy import OccupancyState

MLP_LAYERS = ("density0", "density1", "rgb0", "rgb1", "rgb2")


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


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} does not match the "
                         f"model's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def load_ngp_params(model: NGPModel, tree: Dict[str, Any]) -> NGPModel:
    """Copy a JAX NGPModel params tree into ``model`` (in place)."""
    tables = _table_list(tree["table"])
    if len(tables) != len(model.tables):
        raise ValueError(f"{len(tables)} tables for a model with "
                         f"{len(model.tables)} (grid_impl mismatch?)")
    for i, (dst, src) in enumerate(zip(model.tables, tables)):
        _copy(dst, src, f"table {i}")
    mlp = tree["mlp"]["params"]
    for name in MLP_LAYERS:
        _copy(getattr(model.net, name), mlp[name]["kernel"], f"mlp {name}")
    return model


def ngp_params_to_numpy(model: NGPModel) -> Dict[str, Any]:
    """The inverse of load_ngp_params, in the JAX tree layout."""
    tables = [_numpy(t) for t in model.tables]
    return {"table": tables if model.cfg.grid_impl != "hash" else tables[0],
            "mlp": {"params": {name: {"kernel": _numpy(getattr(model.net, name))}
                               for name in MLP_LAYERS}}}


def occupancy_from_numpy(tree: Dict[str, Any], device=None) -> OccupancyState:
    return OccupancyState(
        density_grid=_tensor(tree["density_grid"]).to(device, torch.float32),
        bitfield=_tensor(tree["bitfield"]).to(device, torch.bool),
        mean_density=_tensor(tree["mean_density"]).to(device, torch.float32),
        ema_step=_tensor(tree["ema_step"]).to(device, torch.int32))


def occupancy_to_numpy(state: OccupancyState) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in state._asdict().items()}
