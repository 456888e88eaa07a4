"""Read the JAX package's NGP checkpoints (counterpart of
myc_nerfs_tpu/core/checkpoint.py).

A checkpoint is a flax-msgpack file of the NGPTrainState tree plus a JSON
sidecar (``<path>.json``, e.g. {"step": N}). Arrays are msgpack ExtType 1
holding msgpack (shape, dtype name, C-order bytes); numpy scalars are
ExtType 3 in the same form. They are read into numpy (bf16 widened to f32,
exactly) and loaded through core/bridge.py. The optimizer state is skipped
until training is ported.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .bridge import load_ngp_params, occupancy_from_numpy

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        u16 = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32)
        return (u16 << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unexpected msgpack extension type {code} in checkpoint")


def read_msgpack_tree(path: str) -> Dict[str, Any]:
    """The raw state dict of a flax-msgpack file, arrays as numpy."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax state-dict checkpoint")
    return tree


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict]:
    """Load params and occupancy from a JAX NGP checkpoint into the
    trainer ``state`` (NGPTrainState; its model is updated in place).
    Returns (new state, sidecar meta)."""
    tree = read_msgpack_tree(path)
    load_ngp_params(state.params, tree["params"])
    occ = occupancy_from_numpy(tree["occ"], state.occ.density_grid.device)
    state = state._replace(occ=occ, step=int(np.asarray(tree["step"])))
    meta: Dict = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(directory: str, name: str = "model.ckpt") -> Optional[str]:
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None
