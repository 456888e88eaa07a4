"""A ("data", "model") mesh of torch.distributed ranks and its collectives
(counterpart of myc_nerfs_tpu/parallel/mesh.py).

The JAX package places arrays with NamedShardings and lets XLA insert the
collectives. Here every rank is one process and each collective is called
by hand:

- ranks are laid out data-major, ``rank = d * model + m``, as
  ``np.asarray(devices).reshape(data, model)`` lays out the JAX mesh; the
  "data" group of a rank is the ranks with its ``m``, its "model" group
  the ranks with its ``d``;
- ``shard_batch`` gives a rank its contiguous slice of a batch over "data"
  (ranks of one model group get the same slice); ``broadcast`` replaces a
  replicated placement; ``all_reduce_mean`` averages gradients in one flat
  bucket; ``gather_rows`` concatenates shards in rank order;
- ``spawn`` starts the ranks (torch.multiprocessing, a FileStore in a
  temporary directory) and returns each rank's result.

The JAX module's ``make_mesh``, ``shard_batch`` and ``replicated`` keep
their names; ``data_sharding``'s placement is ``shard_slice`` (this rank's
rows); ``shard_ngp_params`` is spmd.place_ngp_state with table_mode
'groups'; ``table_sharding`` (each table's rows over "model") is not
ported (spmd.NOT_PORTED['rows']).

Backends: on the card, NCCL with one rank per card; with more ranks than
cards, gloo with ranks sharing the cards (NCCL refuses two ranks on one
card); on the CPU, gloo. gloo reduces and broadcasts CUDA tensors but does
not gather them, and may not take bf16, so every collective here is an
``all_reduce`` or a ``broadcast`` of f32 (or int64) buffers: a gather is a
sum over a zero-filled buffer in which each rank wrote its rows, which is
exact. A mesh of one process (no process group) runs every collective as
the identity.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "single_mesh", "shard_batch", "shard_slice", "broadcast",
           "replicated", "all_reduce_mean", "all_reduce_sum", "gather_rows",
           "choose_backend", "spawn", "AXES"]

AXES = ("data", "model", "world")
# a collective that waits this long for a rank that died raises
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a data x model mesh and its process groups."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Any = None    # the ranks with this rank's model index
    model_group: Any = None   # the ranks with this rank's data index

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis_size(self, axis: str) -> int:
        return {"data": self.data, "model": self.model, "world": self.size}[axis]

    def group(self, axis: str):
        """The process group of ``axis`` ("world": every rank)."""
        if axis not in AXES:
            raise ValueError(f"mesh axis {axis!r}, not one of {AXES}")
        return {"data": self.data_group, "model": self.model_group,
                "world": dist.group.WORLD if self.size > 1 else None}[axis]

    def axis_root(self, axis: str) -> int:
        """The global rank at index 0 of this rank's ``axis`` group."""
        return {"data": self.model_index, "model": self.data_index * self.model,
                "world": 0}[axis]


def single_mesh(device="cpu") -> Mesh:
    """A mesh of one process (1 x 1): every collective is the identity."""
    return Mesh(data=1, model=1, rank=0, device=torch.device(device), backend="none")


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """The mesh of the initialised process group, data-major. Defaults:
    every rank on "data". Every rank must call it (it creates the groups
    in one order). Without a process group: the one-process mesh."""
    if not dist.is_initialized():
        if (data or 1) * model != 1:
            raise ValueError(f"a {data}x{model} mesh needs a process group")
        return single_mesh(device or "cpu")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} != {n} ranks")
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(data=data, model=model, rank=rank, device=torch.device(device),
                backend=dist.get_backend(), data_group=data_group, model_group=model_group)


def shard_slice(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of ``n`` over "data"; n must divide."""
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split evenly over data={mesh.data}")
    k = n // mesh.data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(mesh: Mesh, *tensors, axis: int = 0):
    """Each tensor's slice of this rank along ``axis`` over "data" (default
    the leading axis; blocks of steps shard axis 1, the per-step ray axis).
    The axis must divide evenly, as the JAX package's sharding requires."""
    out = []
    for t in tensors:
        s = shard_slice(mesh, t.shape[axis])
        out.append(t if mesh.data == 1 else t[(slice(None),) * axis + (s,)])
    return tuple(out) if len(out) > 1 else out[0]


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    """What a tensor travels as: f32 (f64 stays f64), int64 for integers
    and booleans."""
    if t.is_floating_point():
        return torch.float64 if t.dtype == torch.float64 else torch.float32
    return torch.int64


def _bucket(tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, list]:
    """One flat buffer of every tensor, in the widest of their wire dtypes."""
    wire = {_wire_dtype(t) for t in tensors}
    dtype = torch.float64 if torch.float64 in wire else (
        torch.float32 if torch.float32 in wire else torch.int64)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    return flat, [(t.shape, t.dtype, t.numel()) for t in tensors]


def _unbucket(flat: torch.Tensor, meta: list) -> List[torch.Tensor]:
    out, at = [], 0
    for shape, dtype, n in meta:
        out.append(flat[at:at + n].reshape(shape).to(dtype))
        at += n
    return out


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str = "data"
                   ) -> List[torch.Tensor]:
    """The sum of each tensor over ``axis``, in one bucket; each comes back
    in its own dtype. Every rank of the group gets the same bits."""
    tensors = list(tensors)
    if not tensors or mesh.axis_size(axis) == 1:
        return tensors
    flat, meta = _bucket(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return _unbucket(flat, meta)


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str = "data"
                    ) -> List[torch.Tensor]:
    """The mean of each tensor over ``axis``: one flat f32 bucket (f64 when
    a tensor is f64) summed, divided by the group's size and cast back to
    each tensor's dtype. With equal shards, the mean of the shards' mean-loss
    gradients is the global mean loss's gradient (what GSPMD's psum gives)."""
    tensors = list(tensors)
    size = mesh.axis_size(axis)
    if not tensors or size == 1:
        return tensors
    flat, meta = _bucket(tensors)
    if not flat.is_floating_point():
        raise TypeError("all_reduce_mean takes floating-point tensors")
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    flat.div_(size)
    return _unbucket(flat, meta)


def broadcast(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str = "world"
              ) -> List[torch.Tensor]:
    """Each tensor as the rank at index 0 of this rank's ``axis`` group
    holds it (one bucket, exact: f32 carries bf16 and f16, int64 carries
    integers and booleans)."""
    tensors = list(tensors)
    if not tensors or mesh.axis_size(axis) == 1:
        return tensors
    flat, meta = _bucket(tensors)
    dist.broadcast(flat, src=mesh.axis_root(axis), group=mesh.group(axis))
    return _unbucket(flat, meta)


def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The replicated placement: every rank takes rank 0's values."""
    return broadcast(mesh, tensors, "world")


def gather_rows(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The shards of every rank of ``axis`` concatenated along dim 0 in
    rank order (every shard the same shape): a sum over a zero-filled
    buffer holding this rank's rows at its offset, exact in the wire dtype."""
    size = mesh.axis_size(axis)
    if size == 1:
        return x
    index = {"data": mesh.data_index, "model": mesh.model_index, "world": mesh.rank}[axis]
    n = x.shape[0]
    full = torch.zeros((size * n,) + tuple(x.shape[1:]), dtype=_wire_dtype(x),
                       device=x.device)
    full[index * n:(index + 1) * n] = x
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return full.to(x.dtype)


def choose_backend(device, n_ranks: int) -> Tuple[str, List[torch.device], str]:
    """(backend, each rank's device, a line naming both): NCCL with one rank
    per card when there are enough cards, gloo with ranks sharing the cards
    otherwise, gloo on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return ("gloo", [torch.device("cpu")] * n_ranks,
                f"mesh: backend gloo, {n_ranks} ranks on the CPU, cards 0")
    if not torch.cuda.is_available():
        raise SystemExit(f"device {device}: torch.cuda.is_available() is false; pass "
                         "device 'cpu' to run on the CPU")
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", r % cards) for r in range(n_ranks)]
    names = sorted({torch.cuda.get_device_name(i) for i in range(cards)})
    if cards >= n_ranks:
        return ("nccl", devices, f"mesh: backend nccl, {n_ranks} ranks, one per card, "
                                 f"cards {cards} ({', '.join(names)})")
    return ("gloo", devices, f"mesh: backend gloo, {n_ranks} ranks sharing {cards} "
                             f"card(s) ({', '.join(names)}); NCCL takes one rank per card")


def _child(rank: int, fn: Callable, n_ranks: int, model: int, device: str, store: str,
           out_dir: str, timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    backend, devices, _ = choose_backend(device, n_ranks)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, n_ranks), rank=rank,
                            world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(make_mesh(model=model, device=dev), *args)
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, device, *args, model: int = 1,
          timeout: float = DEFAULT_TIMEOUT_S, quiet: bool = False) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` processes of a (n_ranks /
    model) x model mesh on ``device`` ("cuda" or "cpu"); returns each rank's
    result (pickled back). ``fn`` and ``args`` must pickle (a function of an
    importable module, numpy arrays, configs). Each collective, and the whole
    launch, gives up after ``timeout`` seconds; a failing rank's traceback
    is raised here and the other ranks are ended."""
    import torch.multiprocessing as mp

    if n_ranks % model:
        raise ValueError(f"{n_ranks} ranks do not split into model={model}")
    _, _, line = choose_backend(device, n_ranks)
    if not quiet:
        print(f"{line}; mesh {n_ranks // model} x {model}", flush=True)
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        ctx = mp.start_processes(_child, args=(fn, n_ranks, model, str(device),
                                               os.path.join(tmp, "store"), tmp, timeout, args),
                                 nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"spawn: {n_ranks} ranks did not finish in {timeout} s")
        results = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
