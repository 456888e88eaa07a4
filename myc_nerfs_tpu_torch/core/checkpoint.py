"""NGP checkpoints in the JAX package's format (counterpart of
myc_nerfs_tpu/core/checkpoint.py), read and written.

A checkpoint is a flax-msgpack file of the NGPTrainState tree -- params,
the optax.adam state, the occupancy grid and the step -- plus a JSON
sidecar (``<path>.json``, e.g. {"step": N}). Arrays are msgpack ExtType 1
holding msgpack (shape, dtype name, C-order bytes); numpy scalars are
ExtType 3 in the same form. The reader loads them into numpy (bf16 widened
to f32, exactly) and through core/bridge.py; the writer stores each tensor
in its own dtype, so ``myc_nerfs_tpu.core.checkpoint.restore_checkpoint``
reads the port's checkpoints into a JAX NGPTrainState. ``msgpack`` is
imported only when a checkpoint is read or written.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .bridge import (adam_from_numpy, adam_tree, load_ngp_params,
                     occupancy_from_numpy, param_tree)

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


def _tensor_ext(t: torch.Tensor):
    """A tensor as flax's ndarray extension: (shape, dtype name, bytes)."""
    import msgpack

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, data = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        a = t.numpy()
        name, data = a.dtype.name, a.tobytes("C")
    return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
        (list(t.shape), name, data), use_bin_type=True))


def save_checkpoint(path: str, state, step: Optional[int] = None,
                    meta: Optional[Dict] = None) -> str:
    """Write the trainer ``state`` (NGPTrainState) to ``path`` in the JAX
    package's layout, and the sidecar {"step": step, **meta}."""
    import msgpack

    model = state.params
    tree = {"params": param_tree(model, model.param_list()),
            "opt_state": adam_tree(model, state.opt_state),
            "occ": dict(state.occ._asdict()),
            "step": torch.tensor(state.step, dtype=torch.int32)}

    def ext(obj):
        if isinstance(obj, torch.Tensor):
            return _tensor_ext(obj)
        raise TypeError(f"cannot store {type(obj).__name__} in a checkpoint")

    def keyed(node):  # flax stores lists as dicts keyed "0", "1", ...
        if isinstance(node, dict):
            return {k: keyed(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return {str(i): keyed(v) for i, v in enumerate(node)}
        return node

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(keyed(tree), default=ext, strict_types=True))
    if meta is not None or step is not None:
        with open(path + ".json", "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
    return path


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict]:
    """Load params, the Adam state, the occupancy grid and the step from an
    NGP checkpoint (the JAX package's or the port's) into the trainer
    ``state`` (NGPTrainState; its model is updated in place). Returns (new
    state, sidecar meta)."""
    tree = read_msgpack_tree(path)
    model = state.params
    load_ngp_params(model, tree["params"])
    occ = occupancy_from_numpy(tree["occ"], state.occ.density_grid.device)
    state = state._replace(occ=occ, step=int(np.asarray(tree["step"])),
                           opt_state=adam_from_numpy(model, tree["opt_state"]))
    meta: Dict = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(directory: str, name: str = "model.ckpt") -> Optional[str]:
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None
