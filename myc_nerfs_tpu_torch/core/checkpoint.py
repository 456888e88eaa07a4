"""Trainer checkpoints in the JAX package's format (counterpart of
myc_nerfs_tpu/core/checkpoint.py), read and written.

A checkpoint is a flax-msgpack file of a trainer state's tree plus a JSON
sidecar (``<path>.json``, e.g. {"step": N}), and with ``keep_snapshot`` a
copy at ``<path without extension>/<step>.ckpt``:
- NGPTrainState: params, the optax.adam state, the occupancy grid and the
  step, for an NGPModel or an OriginNeRFModel alike;
- NeRFTrainState: params (NeRFMLP or the coarse/fine pair), se3_refine,
  both Adam states (opt_state, opt_state_pose), pose_noise and the step;
- a TensoRFTrainer (save_tensorf_checkpoint / read_tensorf_checkpoint):
  params, aabb, alpha_aabb, alpha_volume ((0, 0, 0) without a mask) and
  the optax.multi_transform state of its two Adams, with the sidecar
  {"step", "model_name", "grid_size", "lr_scale", "global_step",
  "has_opt_state"} from which cli/tensorf_train.py rebuilds the stage.

core/bridge.py maps each model's parameters to its JAX tree. Arrays are
msgpack ExtType 1 holding msgpack (shape, dtype name, C-order bytes); numpy
scalars are ExtType 3 in the same form. The reader loads them into numpy
(bf16 widened to f32, exactly); the writer stores each tensor in its own
dtype, so ``myc_nerfs_tpu.core.checkpoint.restore_checkpoint`` reads the
port's checkpoints into the JAX NGPTrainState or NeRFTrainState.

The msgpack codec is this module's own (``packb``/``unpackb``), written from
the format's public specification for the subset a flax state dict uses:
maps, arrays, str, bin, ints, floats, bool, nil and extension types. So a
machine without the msgpack package saves and restores too; the bytes are
those ``msgpack.packb(tree, strict_types=True)`` writes.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..train.nerf_trainer import NeRFTrainState
from .bridge import (_tensor, adam_from_numpy, adam_tree, load_params, occupancy_from_numpy,
                     param_tree, pose_adam_from_numpy, pose_adam_tree, tensorf_adam_tree,
                     tensorf_params_tree)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class ExtType(NamedTuple):
    """A msgpack extension value: a type code and its payload."""

    code: int
    data: bytes


# -- the msgpack codec --------------------------------------------------------


def _pack_into(out: bytearray, obj: Any, default: Optional[Callable]) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True or obj is False:
        out += b"\xc3" if obj else b"\xc2"
    elif type(obj) is int:
        if 0 <= obj < 0x80 or -0x20 <= obj < 0:
            out += struct.pack("b" if obj < 0 else "B", obj)
        elif 0x80 <= obj <= 0xFF:
            out += struct.pack("BB", 0xCC, obj)
        elif -0x80 <= obj < 0:
            out += struct.pack(">Bb", 0xD0, obj)
        elif 0xFF < obj <= 0xFFFF:
            out += struct.pack(">BH", 0xCD, obj)
        elif -0x8000 <= obj < -0x80:
            out += struct.pack(">Bh", 0xD1, obj)
        elif 0xFFFF < obj <= 0xFFFFFFFF:
            out += struct.pack(">BI", 0xCE, obj)
        elif -0x80000000 <= obj < -0x8000:
            out += struct.pack(">Bi", 0xD2, obj)
        elif 0xFFFFFFFF < obj <= 0xFFFFFFFFFFFFFFFF:
            out += struct.pack(">BQ", 0xCF, obj)
        elif -0x8000000000000000 <= obj < -0x80000000:
            out += struct.pack(">Bq", 0xD3, obj)
        else:
            raise OverflowError(f"integer {obj} is out of msgpack's range")
    elif type(obj) is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        n = len(raw)
        out += (struct.pack("B", 0xA0 | n) if n <= 31 else
                struct.pack("BB", 0xD9, n) if n <= 0xFF else
                struct.pack(">BH", 0xDA, n) if n <= 0xFFFF else
                struct.pack(">BI", 0xDB, n))
        out += raw
    elif type(obj) in (bytes, bytearray):
        n = len(obj)
        out += (struct.pack("BB", 0xC4, n) if n <= 0xFF else
                struct.pack(">BH", 0xC5, n) if n <= 0xFFFF else
                struct.pack(">BI", 0xC6, n))
        out += obj
    elif type(obj) is ExtType:
        n = len(obj.data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        out += (struct.pack("B", fixed[n]) if n in fixed else
                struct.pack("BB", 0xC7, n) if n <= 0xFF else
                struct.pack(">BH", 0xC8, n) if n <= 0xFFFF else
                struct.pack(">BI", 0xC9, n))
        out += struct.pack("b", obj.code)
        out += obj.data
    elif type(obj) in (list, tuple):
        n = len(obj)
        out += (struct.pack("B", 0x90 | n) if n <= 15 else
                struct.pack(">BH", 0xDC, n) if n <= 0xFFFF else
                struct.pack(">BI", 0xDD, n))
        for v in obj:
            _pack_into(out, v, default)
    elif type(obj) is dict:
        n = len(obj)
        out += (struct.pack("B", 0x80 | n) if n <= 15 else
                struct.pack(">BH", 0xDE, n) if n <= 0xFFFF else
                struct.pack(">BI", 0xDF, n))
        for k, v in obj.items():
            _pack_into(out, k, default)
            _pack_into(out, v, default)
    elif default is not None:
        _pack_into(out, default(obj), None)
    else:
        raise TypeError(f"cannot store {type(obj).__name__} in msgpack")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    """msgpack bytes of ``obj`` (None, bool, int, float, str, bytes, list,
    tuple, dict, ExtType), as msgpack.packb(obj, default=default,
    strict_types=True) writes them; other types go through ``default``."""
    out = bytearray()
    _pack_into(out, obj, default)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, ext_hook: Optional[Callable]):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = bytes(self.take(n))
        return self.ext_hook(code, data) if self.ext_hook else ExtType(code, data)

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: ">H", 0xC6: ">I"}     # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: "B", 0xDA: ">H", 0xDB: ">I"}     # str
        if b in sized:
            return str(self.take(self.unpack(sized[b])), "utf-8")
        sized = {0xC7: "B", 0xC8: ">H", 0xC9: ">I"}     # ext
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset read here")


def unpackb(data: bytes, ext_hook: Optional[Callable] = None) -> Any:
    """The object of msgpack ``data`` (the subset packb writes, plus float32
    and the other extension sizes); strings decode as UTF-8, extension
    values go through ``ext_hook(code, data)``."""
    reader = _Reader(data, ext_hook)
    obj = reader.read()
    if reader.pos != len(data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


# -- flax's extension types ---------------------------------------------------


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if dtype_name == "bfloat16":
        u16 = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32)
        return (u16 << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unexpected msgpack extension type {code} in checkpoint")


def read_msgpack_tree(path: str) -> Dict[str, Any]:
    """The raw state dict of a flax-msgpack file, arrays as numpy."""
    with open(path, "rb") as f:
        tree = unpackb(f.read(), ext_hook=_ext_hook)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax state-dict checkpoint")
    return tree


def tensor_payload(t: torch.Tensor) -> Tuple[list, str, bytes]:
    """(shape, dtype name, C-order bytes): flax's ndarray record of a tensor."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
    a = t.numpy()
    return list(t.shape), a.dtype.name, a.tobytes("C")


def _tensor_ext(obj: Any) -> ExtType:
    if isinstance(obj, torch.Tensor):
        return ExtType(_EXT_NDARRAY, packb(tensor_payload(obj)))
    raise TypeError(f"cannot store {type(obj).__name__} in a checkpoint")


def state_tree(state) -> Dict[str, Any]:
    """The trainer ``state`` (NGPTrainState or NeRFTrainState) as the flax
    state dict a checkpoint holds, tensors as leaves (lists keyed "0", "1",
    ... as flax stores them)."""
    model = state.params
    tree = {"params": param_tree(model, model.param_list()),
            "opt_state": adam_tree(model, state.opt_state),
            "step": torch.as_tensor(state.step, dtype=torch.int32)}
    if isinstance(state, NeRFTrainState):
        tree.update(se3_refine=state.se3_refine,
                    opt_state_pose=pose_adam_tree(state.opt_state_pose),
                    pose_noise=state.pose_noise)
    else:
        tree["occ"] = dict(state.occ._asdict())

    def keyed(node):
        if isinstance(node, dict):
            return {k: keyed(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return {str(i): keyed(v) for i, v in enumerate(node)}
        return node

    return keyed(tree)


def save_checkpoint(path: str, state, step: Optional[int] = None,
                    meta: Optional[Dict] = None, keep_snapshot: bool = False) -> str:
    """Write the trainer ``state`` (NGPTrainState or NeRFTrainState) to
    ``path`` in the JAX package's layout, the sidecar {"step": step, **meta},
    and with ``keep_snapshot`` (and a step) a copy at
    ``<path without extension>/<step>.ckpt`` (barf util.py:167-187)."""
    data = packb(state_tree(state), default=_tensor_ext)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    if meta is not None or step is not None:
        with open(path + ".json", "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
    if keep_snapshot and step is not None:
        snap_dir = os.path.splitext(path)[0]
        os.makedirs(snap_dir, exist_ok=True)
        with open(os.path.join(snap_dir, f"{step}.ckpt"), "wb") as f:
            f.write(data)
    return path


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict]:
    """Load a checkpoint (the JAX package's or the port's) into the trainer
    ``state``, its model updated in place: for an NGPTrainState params, the
    Adam state, the occupancy grid and the step; for a NeRFTrainState
    params, se3_refine, both Adam states, pose_noise and the step. Returns
    (new state, sidecar meta)."""
    tree = read_msgpack_tree(path)
    model = state.params
    load_params(model, tree["params"])
    opt_state = adam_from_numpy(model, tree["opt_state"])
    if isinstance(state, NeRFTrainState):
        like = state.se3_refine
        state = state._replace(
            se3_refine=_tensor(tree["se3_refine"]).to(like.device, like.dtype),
            opt_state=opt_state,
            opt_state_pose=pose_adam_from_numpy(tree["opt_state_pose"], like),
            pose_noise=_tensor(tree["pose_noise"]).to(like.device, like.dtype),
            step=_tensor(tree["step"]).to(like.device, torch.int32))
    else:
        occ = occupancy_from_numpy(tree["occ"], state.occ.density_grid.device)
        state = state._replace(occ=occ, step=int(np.asarray(tree["step"])),
                               opt_state=opt_state)
    meta: Dict = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def latest_checkpoint(directory: str, name: str = "model.ckpt") -> Optional[str]:
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None


def tensorf_state_tree(trainer) -> Dict[str, Any]:
    """A TensoRFTrainer's checkpoint tree, tensors as leaves, keys sorted."""
    vol = trainer.buffers.get("alpha_volume")
    return {"aabb": trainer.buffers["aabb"], "alpha_aabb": trainer.buffers["alpha_aabb"],
            "alpha_volume": vol if vol is not None else torch.zeros((0, 0, 0)),
            "opt_state": tensorf_adam_tree(trainer.params, trainer.opt_spatial,
                                           trainer.opt_net),
            "params": tensorf_params_tree(trainer.params, leaf=lambda t: t)}


def save_tensorf_checkpoint(path: str, trainer, model_name: str) -> str:
    """Write a TensoRFTrainer's state and its sidecar in the JAX package's
    layout (cli/tensorf_train.py::save_tensorf_ckpt there)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(tensorf_state_tree(trainer), default=_tensor_ext))
    with open(path + ".json", "w") as f:
        json.dump({"step": trainer.global_step, "model_name": model_name,
                   "grid_size": list(trainer.geom.grid_size), "lr_scale": trainer.lr_scale,
                   "global_step": trainer.global_step, "has_opt_state": True}, f)
    return path


def read_tensorf_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict]:
    """(the checkpoint's tree as numpy, its sidecar)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    return read_msgpack_tree(path), meta
