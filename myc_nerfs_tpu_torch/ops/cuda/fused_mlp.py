"""Fused bias-free MLP: the Hopper kernels' wrappers and their plain versions.

Counterpart of myc_nerfs_tpu/ops/pallas/fused_mlp.py. ``fused_mlp(x,
weights)`` computes y = Wn(...relu(W1 relu(W0 x))...) with f32
accumulation and a cast to x's dtype after every layer, and is
differentiable (a ``torch.autograd.Function``, the JAX custom VJP):

- on CUDA tensors the forward and the backward launch the hand-written
  kernels in ``csrc/fused_mlp.cu`` (built with nvcc on first use) or raise;
- on CPU tensors they run ``fused_mlp_reference`` and
  ``fused_mlp_backward_reference``, the plain versions.

The backward follows the Pallas ``_bwd_kernel``: it recomputes the
forward's post-activations (rounded to x's dtype), accumulates each dW in
f32 from the unrounded f32 gradient, and rounds the gradient to x's dtype
before each dgrad product. Weights use the JAX layout, [in, out] per layer.

On CUDA tensors the wrapper zero-pads every width to a multiple of 16 (zero
rows and columns stay zero through ReLU) and slices the padding off the
results. Chains up to 64 wide (both NGP MLPs) take the narrow kernels
(weights staged once per CTA); chains with a width above 64, up to 272
(OriginNeRF's 64 -> 257 x 8 backbone with its biases folded in), take the
wide kernels (``fused_mlp_wide``, ``fused_mlp_wide_backward``: weights
streamed through shared memory, a backward through global scratch, on wgmma
with TMA and bulk copies, with the launch shape and scratch of
``wide_plan``). At most 8 layers, in bf16 (tensor cores) or f32: the
narrow kernels, and the wide backward's recompute and dgrad, on the CUDA
cores; the wide forward and dW as 3xTF32 on the tensor cores
(``split_tf32``; ``mm_3xtf32``, ``forward_3xtf32`` and ``backward_3xtf32``
emulate their products, planted faults included). Anything wider raises.
The plain versions take any widths; ``fused_mlp_plain`` runs them on any
device (the kernels' yardstick in a model's gradient). ``mlp_work`` gives a
call's flops, bytes and its H100 bound from the shapes; ``exact_inputs``
draws a chain on which every summation order gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ...utils.timing import roofline
from . import _build
from ._build import I32, I64, PTR, STREAM

SOURCE = _build.CSRC / "fused_mlp.cu"
_PTRS, _INTS = ctypes.POINTER(PTR), ctypes.POINTER(I32)
LIB = _build.Library(SOURCE, {
    "fused_mlp_plan": [_INTS, I32, I32, I32, _INTS, _INTS],
    "fused_mlp_fwd": [PTR, PTR, _PTRS, _INTS, I32, I64, I32, I32, STREAM],
    "fused_mlp_bwd": [PTR, PTR, PTR, PTR, PTR, I32, _PTRS, _INTS, I32, I64, I32, STREAM],
    "fused_mlp_wide_init": [],
    "fused_mlp_wide_fwd": [PTR, PTR, _PTRS, _INTS, I32, I64, I32, I32, PTR, I64, STREAM],
    "fused_mlp_wide_bwd_f32": [PTR, PTR, PTR, PTR, _PTRS, _INTS, I32, I64, _PTRS, I64, PTR,
                               I64, PTR, I32, I64, I32, I32, STREAM],
    "fused_mlp_wide_bwd_bf16": [PTR, PTR, PTR, PTR, _PTRS, _INTS, I32, I64, _PTRS, I64, PTR,
                                I32, I64, I32, I32, STREAM],
})
MAX_LAYERS = 8
MAX_WIDTH = 64         # the narrow kernels
WIDE_MAX_WIDTH = 272   # the wide kernels
WIDTH_STEP = 16        # the kernels' width granularity; the wrapper pads to it
# The wide kernels (csrc/fused_mlp.cu, which alone lays out their shared
# memory): a CTA takes 128-row tiles (two warpgroups of one 64-row block
# each); the dW kernel's CTA takes 128 din rows.
WIDE_TILE_ROWS = 128
WIDE_BLOCK_ROWS = 64
WIDE_DW_SLICE = 128
WIDE_THREADS_PER_GROUP = 128  # a warpgroup
WIDE_TF32_PAD = (64, 256, 272)  # f32: the wgmma N a step's B is padded to (n <= 64, <= 256, above)
# The bit planes' sizes (the C backward entries check the size they are given):
WIDE_BIT_WORDS = 5  # words of ReLU-mask bits a thread keeps per 64-row block (272 / 8 x 4 bits)
WIDE_F32_BIT_WORDS = 3  # f32: words of ReLU-mask bits a thread keeps per 64-row block (4 x 17 bits)
WIDE_F32_THREADS = 256  # f32: threads of the CUDA-core chain kernels
WIDE_DW_WAVES = 4  # waves of dW CTAs: more, shorter CTAs balance the slices' unequal work
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def fused_mlp_reference(x: torch.Tensor,
                        weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch forward: the CPU path and the kernel's oracle. Sums in
    f32 (f64 for f64 inputs, so that gradcheck can run on it)."""
    acc = _acc_dtype(x)
    h = x
    n = len(weights)
    for i, w in enumerate(weights):
        h = h.to(acc) @ w.to(acc)
        if i < n - 1:
            h = torch.relu(h)
        h = h.to(x.dtype)
    return h


def fused_mlp_backward_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                                 g: torch.Tensor, need_dx: bool = True
                                 ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """Plain PyTorch backward, step by step as the Pallas ``_bwd_kernel``:
    the CPU path and the backward kernel's oracle. Returns (dx in x's
    dtype, or None without ``need_dx``; [dW_i in W_i's dtype]).

    Not the autograd of fused_mlp_reference: in bf16 that would round the
    gradient at every layer boundary before dW, and the kernel does not."""
    acc = _acc_dtype(x)
    n = len(weights)
    post = [x]  # post-activation input of each layer, in x's dtype
    for w in weights[:-1]:
        post.append(torch.relu(post[-1].to(acc) @ w.to(acc)).to(x.dtype))
    g = g.to(x.dtype).to(acc)
    dws: List[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i in range(n - 1, -1, -1):
        dws[i] = (post[i].to(acc).T @ g).to(weights[i].dtype)
        if i == 0 and not need_dx:
            return None, dws
        g = g.to(x.dtype).to(acc) @ weights[i].to(acc).T
        if i > 0:
            g = g * (post[i].to(acc) > 0.0)
    return g.to(x.dtype), dws


def mlp_work(widths: Sequence[int], rows: int, dtype: torch.dtype,
             backward: bool = False) -> dict:
    """The work of fused_mlp (or, with ``backward``, of fused_mlp_backward)
    on ``rows`` rows, from the shapes alone: the function's flops, the
    bytes it must move (x, y or g, dx and the weights and dW, each read or
    written once) and its H100 bound (utils.timing.roofline). In f32 the
    least time for f32-accurate products is three TF32 passes on the tensor
    cores (3 x flops at 495 TFLOP/s); ``bound_ms_fma`` and ``bound_by_fma``
    keep the bound of the CUDA cores' f32 FMAs (67 TFLOP/s)."""
    size = torch.empty((), dtype=dtype).element_size()
    macs = [a * b for a, b in zip(widths[:-1], widths[1:])]
    if backward:
        # recompute the hidden layers, dW of every layer, dgrad down to dx
        flops = 2 * rows * (sum(macs[:-1]) + 2 * sum(macs))
        nbytes = (rows * (2 * widths[0] + widths[-1]) + 2 * sum(macs)) * size
    else:
        flops = 2 * rows * sum(macs)
        nbytes = (rows * (widths[0] + widths[-1]) + sum(macs)) * size
    if dtype != torch.float32:
        return roofline(flops, nbytes, dtype)
    fma = roofline(flops, nbytes, torch.float32)
    work = roofline(3 * flops, nbytes, "tf32")
    return {**work, "flops": flops, "bound_ms_fma": fma["bound_ms"],
            "bound_by_fma": fma["bound_by"]}


@dataclass(frozen=True)
class WidePlan:
    """The launch shape and scratch of the wide kernels for one call
    (wide_plan). Scratch sizes count elements of the dtype (the blocked
    planes), floats of the partial dW and, in f32, floats of the weights
    split for the tensor cores (prep)."""
    widths: Tuple[int, ...]
    rows: int
    dtype: torch.dtype
    chain_ctas: int          # CTAs of a chain kernel (a persistent grid)
    dw_slices: int           # dW CTAs of one layer along din (128 din rows each)
    dw_splits: int           # row splits of the dW product
    dw_split_rows: int       # rows of one split (a multiple of 64)
    planes: Tuple[Tuple[str, int, int], ...]  # (name, offset, width) of each plane
    plane_rows: int          # rows of each plane (whole 128-row tiles)
    scratch_elems: int
    partial_floats: int
    bit_words: int           # 4-byte words of each bit plane (the C entry checks them)
    prep_floats: int = 0     # f32: each layer's W^T and W as big and small TF32 planes

    @property
    def scratch_bytes(self) -> int:
        return self.scratch_elems * torch.empty((), dtype=self.dtype).element_size()


def tf32_prep_floats(n: int, k: int) -> int:
    """Floats of one layer's weights as an f32 chain step of ``n`` columns
    and depth ``k`` reads them: k/8 chunks of a big and a small plane of 8 x
    n columns, n padded to the step's wgmma (WIDE_TF32_PAD)."""
    pad = next(p for p in WIDE_TF32_PAD if n <= p)
    return k // 8 * 16 * pad


def wide_plan(widths: Sequence[int], rows: int, dtype: torch.dtype,
              sms: int = 132) -> WidePlan:
    """The wide kernels' launch shape for a chain of ``widths`` (multiples
    of 16 up to 272) over ``rows`` rows on a card with ``sms`` SMs.

    The chain kernels run min(sms, tiles) CTAs over 128-row tiles (f32's
    CUDA-core backward chains two per SM). The backward's scratch is a
    blocked plane (64-row blocks, rows padded to whole tiles) per post_i
    (post_0 = x) and per gradient: in bf16 g_hi_i, and g_lo_i below the
    top; in f32 g_i. Then the bit planes of the ReLU masks of post_1...
    The dW kernel's CTAs each take 128 din rows (a slice) of one layer, and
    the rows are split into WIDE_DW_WAVES waves of ``sms`` CTAs. f32 also
    needs ``prep_floats`` floats: the forward's weights split for the
    tensor cores, or the backward's W^T copies (fewer)."""
    widths = tuple(int(w) for w in widths)
    n = len(widths) - 1
    dw_floats = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    tiles = -(-rows // WIDE_TILE_ROWS)
    plane_rows = tiles * WIDE_TILE_ROWS
    slices = max(-(-d // WIDE_DW_SLICE) for d in widths[:-1])
    blocks = -(-rows // WIDE_BLOCK_ROWS)
    splits = max(1, min(blocks, WIDE_DW_WAVES * sms // (slices * n)))
    per = -(-blocks // splits) if blocks else 1
    splits = max(1, -(-blocks // per))
    f32 = dtype == torch.float32
    grads = (("g", widths[1:]),) if f32 else (("hi", widths[1:]), ("lo", widths[1:-1]))
    planes, off = [], 0
    for name, ws in (("post", widths[:-1]),) + grads:
        for i, w in enumerate(ws):
            planes.append((f"{name}{i}", off, w))
            off += plane_rows * w
    # the ReLU masks of post_1.., as bits (4 bytes a word: 1 f32, 2 bf16 elements)
    bit_elems = (WIDE_F32_BIT_WORDS * WIDE_F32_THREADS if f32
                 else WIDE_BIT_WORDS * WIDE_THREADS_PER_GROUP * 2) // WIDE_BLOCK_ROWS
    for i in range(1, n):
        planes.append((f"bits{i}", off, bit_elems))
        off += plane_rows * bit_elems
    # the forward's split weights (the backward's W^T fit in the same room)
    prep = sum(tf32_prep_floats(b, a) for a, b in zip(widths[:-1], widths[1:])) if f32 else 0
    return WidePlan(widths, rows, dtype, max(1, min(sms, tiles)), slices, splits,
                    per * WIDE_BLOCK_ROWS, tuple(planes), plane_rows, off, splits * dw_floats,
                    plane_rows * bit_elems * (4 if f32 else 2) // 4, prep)


def wide_planes(plan: WidePlan, scratch: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """The scratch's planes as views of ``scratch`` (plan.scratch_elems
    elements), in the order the backward's C entry takes them: bf16
    (fused_mlp_wide_bwd_bf16) post_0.., g_hi_0.., g_lo_0.. (None for the top
    layer's), bits_0.. (None for x's); f32 (fused_mlp_wide_bwd_f32)
    post_0.., g_0.., bits_0.. (None for x's)."""
    views = {name: scratch[off:off + plan.plane_rows * w]
             for name, off, w in plan.planes}
    n = len(plan.widths) - 1
    names = ("post", "g", "bits") if plan.dtype == torch.float32 else ("post", "hi", "lo", "bits")
    return [views.get(f"{name}{i}") for name in names for i in range(n)]


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of an f32 tensor, as the wide f32 kernels split every
    operand for the TF32 tensor cores: big is v with its low 13 mantissa
    bits cleared (a NaN keeps a payload bit, so it stays a NaN; big never
    overflows), small the TF32 rounding (to nearest, ties away from zero)
    of v - big, which f32 holds exactly; where v is not finite big carries
    it alone and small is 0."""
    u = v.contiguous().view(torch.int32)
    finite = torch.isfinite(v)
    nan_bit = torch.where(torch.isnan(v), 0x00400000, 0).to(torch.int32)
    big = ((u & -0x2000) | nan_bit).view(torch.float32)
    rest = torch.where(finite, v - big, torch.zeros_like(v)).view(torch.int32)
    # ties away from zero: add half a TF32 ulp to the magnitude, then cut
    small = ((rest + 0x1000) & -0x2000).view(torch.float32)
    return big, small


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, fault: Optional[str] = None) -> torch.Tensor:
    """a @ b (f32) as the wide f32 kernels form it: small(a) big(b) +
    fin(a) small(b) + big(a) big(b) into one f32 accumulator (split_tf32;
    fin(a) is big(a) where a is finite, else 0). A ``fault`` plants what a
    faulty kernel would do, to read what a check sees of it: 'one_pass'
    rounds both operands to TF32 (nearest, ties away) and takes one
    product; 'no_small_a' drops the small(a) big(b) term."""
    if fault == "one_pass":
        def rnd(v):
            return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        return rnd(a) @ rnd(b)
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    acc = torch.where(torch.isfinite(a), a_big, torch.zeros_like(a)) @ b_small + a_big @ b_big
    return acc if fault == "no_small_a" else a_small @ b_big + acc


def forward_3xtf32(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   fault: Optional[str] = None) -> torch.Tensor:
    """fused_mlp_reference in f32 with every product formed as the wide
    f32 forward kernel forms it (mm_3xtf32, with its ``fault``)."""
    h = x
    for i, w in enumerate(weights):
        h = mm_3xtf32(h, w, fault)
        if i + 1 < len(weights):
            h = torch.relu(h)
    return h


def backward_3xtf32(x: torch.Tensor, weights: Sequence[torch.Tensor], g: torch.Tensor,
                    need_dx: bool = True, fault: Optional[str] = None
                    ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """fused_mlp_backward_reference in f32 with each dW_i = post_i^T g
    formed as the wide f32 dW kernel forms it (mm_3xtf32, post the register
    operand, with its ``fault``); the recompute and the dgrad as the plain
    version's steps, as the kernels' CUDA-core chains take them."""
    post = [x]
    for w in weights[:-1]:
        post.append(torch.relu(post[-1] @ w))
    dws: List[torch.Tensor] = [None] * len(weights)  # type: ignore[list-item]
    for i in range(len(weights) - 1, -1, -1):
        dws[i] = mm_3xtf32(post[i].T.contiguous(), g, fault)
        if i == 0 and not need_dx:
            return None, dws
        g = g @ weights[i].T
        if i > 0:
            g = g * (post[i] > 0.0)
    return g, dws


def split_bf16(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g_hi, g_lo) in bf16 of an f32 gradient, as the wide dgrad writes
    them: g_hi = bf16(g), g_lo = bf16(g - g_hi); where the head is not
    finite (NaN, inf, or an f32 value beyond bf16's range) it carries the
    value alone and g_lo is 0."""
    hi = g.to(torch.bfloat16)
    hf = hi.float()
    lo = torch.where(hf.abs() <= 3.0e38, g - hf, torch.zeros_like(g))
    return hi, lo.to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _wide_library(lib: _build.Library, device: int) -> _build.Library:
    """``lib``, with the wide kernels' shared-memory limit lifted on
    ``device`` (once per library and device)."""
    with torch.cuda.device(device):
        err = lib.load()["fused_mlp_wide_init"]()
    if err != 0:
        raise RuntimeError(f"fused_mlp wide kernels: init failed (error {err}: "
                           f"{lib.error_text(err)})")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(widths: Tuple[int, ...], code: int, backward: bool,
          device: int) -> Tuple[int, int]:
    """(CTAs of the persistent grid, rows a CTA takes per step) of one
    kernel for a layer chain on one device, worked out once: the C side's
    occupancy query and shared-memory limit stay out of every call."""
    ctas, rows = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = LIB.load()["fused_mlp_plan"]((ctypes.c_int * len(widths))(*widths),
                                           len(widths) - 1, code, int(backward),
                                           ctypes.byref(ctas), ctypes.byref(rows))
    if err == -2:
        raise ValueError(f"fused_mlp {'backward ' if backward else ''}kernel: "
                         f"widths {list(widths)} need more shared memory than "
                         "a CTA can have")
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel plan failed (error {err}: {LIB.error_text(err)})")
    return ctas.value, rows.value


def _ctas(widths: Sequence[int], x: torch.Tensor, backward: bool) -> int:
    ctas, rows = _plan(tuple(widths), _DTYPE_CODE[x.dtype], backward, x.device.index)
    return max(1, min(ctas, -(-x.shape[0] // rows)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernels move 16-byte
    vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_chain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [M, D_in], got shape {tuple(x.shape)}")
    if not weights:
        raise ValueError("fused_mlp needs at least one layer")
    d = x.shape[1]
    for i, w in enumerate(weights):
        if w.dim() != 2 or w.shape[0] != d:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not "
                             f"take a width-{d} input")
        d = w.shape[1]


def _kernel_widths(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> List[int]:
    """The checks every kernel shares; returns the layer widths."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mlp kernel takes float32 or bfloat16, got {x.dtype}")
    if len(weights) > MAX_LAYERS:
        raise ValueError(f"fused_mlp kernel takes at most {MAX_LAYERS} layers")
    widths = [x.shape[1]] + [w.shape[1] for w in weights]
    if any(d > WIDE_MAX_WIDTH for d in widths):
        raise ValueError(f"fused_mlp kernels take widths up to {WIDE_MAX_WIDTH}, "
                         f"got {widths}")
    for w in weights:
        if w.device != x.device or w.dtype != x.dtype:
            raise ValueError("fused_mlp: weights must share x's device and dtype")
    return widths


def padded_widths(widths: Sequence[int]) -> List[int]:
    """Each width rounded up to the kernels' granularity (16)."""
    return [-(-d // WIDTH_STEP) * WIDTH_STEP for d in widths]


def pad_chain(x: torch.Tensor, weights: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, List[torch.Tensor], List[int]]:
    """(x, weights, widths) zero-padded to widths that are multiples of 16.
    The padded chain computes the same values, and zeros in the padding:
    a zero column of x meets a zero row of W_0, and a zero column of W_i is
    zero after ReLU, where it meets a zero row of W_i+1."""
    widths = [x.shape[1]] + [w.shape[1] for w in weights]
    padded = padded_widths(widths)
    if padded != widths:
        x = torch.nn.functional.pad(x, (0, padded[0] - widths[0]))
        weights = [torch.nn.functional.pad(w, (0, padded[i + 1] - widths[i + 1],
                                               0, padded[i] - widths[i]))
                   for i, w in enumerate(weights)]
    return x, list(weights), padded


def _c_args(weights: Sequence[torch.Tensor], widths: Sequence[int]):
    return ((ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights]),
            (ctypes.c_int * len(widths))(*widths))


def _forward(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_mlp_reference(x, weights)
    d_out = _kernel_widths(x, weights)[-1]
    x, weights, widths = pad_chain(x, weights)
    if max(widths) > MAX_WIDTH:
        y = fused_mlp_wide(x, weights)
    else:
        y = _narrow_forward(x, weights, widths)
    return y if widths[-1] == d_out else y[:, :d_out]


def _narrow_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    widths: List[int]) -> torch.Tensor:
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    y = torch.empty((x.shape[0], widths[-1]), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    ctas = _ctas(widths, x, backward=False)
    LIB.launch("fused_mlp_fwd", x.device, x.data_ptr(), y.data_ptr(), *_c_args(weights, widths),
               len(weights), x.shape[0], _DTYPE_CODE[x.dtype], ctas, counter="launch.fused_mlp")
    return y


def fused_mlp_backward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       g: torch.Tensor, need_dx: bool = True
                       ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """(dx, [dW_i]) of fused_mlp at x for the output gradient g [M, D_out].

    CPU tensors take fused_mlp_backward_reference. CUDA tensors launch the
    backward kernel (then a fixed-order sum of the CTAs' partial dW, so the
    result does not change from run to run); anything the kernel does not
    take raises, and so does a failed build or launch."""
    _check_chain(x, weights)
    if g.shape != (x.shape[0], weights[-1].shape[1]):
        raise ValueError(f"g has shape {tuple(g.shape)}, the output "
                         f"{(x.shape[0], weights[-1].shape[1])}")
    if x.device.type == "cpu":
        return fused_mlp_backward_reference(x, weights, g, need_dx)
    real = _kernel_widths(x, weights)
    if g.device != x.device:
        raise ValueError("fused_mlp backward: g must share x's device")
    x, weights, widths = pad_chain(x, weights)
    g = g.to(x.dtype)
    if widths[-1] != real[-1]:
        g = torch.nn.functional.pad(g, (0, widths[-1] - real[-1]))
    if max(widths) > MAX_WIDTH:
        dx, dws = fused_mlp_wide_backward(x, weights, g, need_dx)
    else:
        dx, dws = _narrow_backward(x, weights, g, widths, need_dx)
    if widths != real:
        dx = dx[:, :real[0]] if dx is not None else None
        dws = [dw[:a, :b] for dw, a, b in zip(dws, real[:-1], real[1:])]
    return dx, dws


def _narrow_backward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     g: torch.Tensor, widths: List[int], need_dx: bool
                     ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    m = x.shape[0]
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    g = _aligned(g)
    sizes = [a * b for a, b in zip(widths[:-1], widths[1:])]
    dw = torch.empty(sum(sizes), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    if m == 0:
        dw.zero_()
    else:
        ctas = _ctas(widths, x, backward=True)
        partial = torch.empty((ctas, sum(sizes)), dtype=torch.float32, device=x.device)
        LIB.launch("fused_mlp_bwd", x.device, x.data_ptr(), g.data_ptr(),
                   dx.data_ptr() if need_dx else None, dw.data_ptr(), partial.data_ptr(), ctas,
                   *_c_args(weights, widths), len(weights), m, _DTYPE_CODE[x.dtype],
                   counter="launch.fused_mlp_bwd")
    dws = [t.view(a, b) for t, a, b in
           zip(torch.split(dw, sizes), widths[:-1], widths[1:])]
    return dx, dws


def fused_mlp_wide(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The wide forward kernel on CUDA tensors whose widths are multiples
    of 16 up to 272 (fused_mlp pads and calls it for chains above 64)."""
    widths = [x.shape[1]] + [w.shape[1] for w in weights]
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    y = torch.empty((x.shape[0], widths[-1]), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _wide_library(LIB, x.device.index)
    plan = wide_plan(widths, x.shape[0], x.dtype, _sms(x.device.index))
    prep = torch.empty(plan.prep_floats, dtype=torch.float32, device=x.device)
    lib.launch("fused_mlp_wide_fwd", x.device, x.data_ptr(), y.data_ptr(),
               *_c_args(weights, widths), len(weights), x.shape[0], _DTYPE_CODE[x.dtype],
               plan.chain_ctas, prep.data_ptr() or None, plan.prep_floats,
               counter="launch.fused_mlp_wide")
    return y


def fused_mlp_wide_backward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                            g: torch.Tensor, need_dx: bool = True
                            ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """The wide backward kernels on CUDA tensors as fused_mlp_wide takes
    them, g [M, D_out] in x's dtype. Scratch (wide_plan: the recomputed
    post-activations, each layer's gradient, the row splits' partial dW
    and, in f32, the split weights) is allocated here and released with the
    call."""
    widths = [x.shape[1]] + [w.shape[1] for w in weights]
    m, dtype = x.shape[0], x.dtype
    x = _aligned(x)
    weights = [_aligned(w) for w in weights]
    g = _aligned(g)
    sizes = [a * b for a, b in zip(widths[:-1], widths[1:])]
    dw = torch.empty(sum(sizes), dtype=dtype, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    if m == 0:
        dw.zero_()
    else:
        lib = _wide_library(LIB, x.device.index)
        plan = wide_plan(widths, m, dtype, _sms(x.device.index))
        scratch = torch.empty(plan.scratch_elems, dtype=dtype, device=x.device)
        partial = torch.empty(plan.partial_floats, dtype=torch.float32, device=x.device)
        planes = [p.data_ptr() if p is not None else None for p in wide_planes(plan, scratch)]
        head = (x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None, dw.data_ptr(),
                *_c_args(weights, widths), len(weights), m,
                (ctypes.c_void_p * len(planes))(*planes), plan.bit_words)
        tail = (partial.data_ptr(), plan.dw_splits, plan.dw_split_rows // WIDE_BLOCK_ROWS,
                plan.dw_slices, plan.chain_ctas)
        if dtype == torch.bfloat16:
            lib.launch("fused_mlp_wide_bwd_bf16", x.device, *head, *tail,
                       counter="launch.fused_mlp_wide_bwd")
        else:
            prep = torch.empty(plan.prep_floats, dtype=torch.float32, device=x.device)
            lib.launch("fused_mlp_wide_bwd_f32", x.device, *head, prep.data_ptr(),
                       plan.prep_floats, *tail, counter="launch.fused_mlp_wide_bwd")
    dws = [t.view(a, b) for t, a, b in
           zip(torch.split(dw, sizes), widths[:-1], widths[1:])]
    return dx, dws


class _FusedMLP(torch.autograd.Function):
    """fused_mlp and fused_mlp_plain with their backward: saves x and the
    weights (not the activations; the backward recomputes them, as the
    Pallas kernel does). ``backward`` is None for the kernels' path, else
    the plain backward to run (the forward is then the plain one too)."""

    @staticmethod
    def forward(ctx, backward, x, *weights):
        ctx.plain_backward = backward
        ctx.save_for_backward(x, *weights)
        return _forward(x, weights) if backward is None else fused_mlp_reference(x, weights)

    @staticmethod
    def backward(ctx, gy):
        x, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        dx, dws = (ctx.plain_backward or fused_mlp_backward)(x, weights, gy, need_dx=need[0])
        return (None, dx if need[0] else None,
                *[dw if n else None for dw, n in zip(dws, need[1:])])


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """y = Wn(...relu(W1 relu(W0 x))...): x [M, D_in], weights[i] [D_i, D_i+1].

    CPU tensors take the plain versions. CUDA tensors launch the kernels,
    the backward one when autograd asks for a gradient; anything the kernels
    do not take raises, and so does a failed build or launch.
    """
    _check_chain(x, weights)
    return _FusedMLP.apply(None, x, *weights)


def fused_mlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    backward=fused_mlp_backward_reference) -> torch.Tensor:
    """fused_mlp through its plain versions on any device: the kernels'
    yardstick inside a model's gradient (OriginNeRFModel.mlp). ``backward``,
    with fused_mlp_backward_reference's signature, replaces the plain
    backward (a planted fault, to read what a check sees of it)."""
    _check_chain(x, weights)
    return _FusedMLP.apply(backward, x, *weights)


def exact_inputs(widths: Sequence[int], rows: int, dtype: torch.dtype, device,
                 seed: int = 0) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """(x, weights, g) of integers, drawn on the CPU from ``seed``: x in
    {0, 1, 2}, g in {-2, ..., 2}, weights sparse in {-1, 0, 1} (1 in 32
    nonzero), so activations stay small. Every product and sum of the
    forward, the dgrad chain and dW is then an f32 integer, exact (in any
    summation order, so the kernels must match the plain versions bit for
    bit) where the magnitudes summed into one element stay below 2^24: at
    [64, 257 x 8] up to 16384 rows, and in practice at 131072. The deeper
    layers' gradients outgrow bf16's 8-bit integers, so their rounding to
    bf16 before each dgrad shows in dx, and dW's use of the unrounded
    gradient in dW."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 3, (rows, widths[0]), generator=gen).float()
    ws = [torch.randint(-1, 2, (a, b), generator=gen).float()
          * (torch.rand((a, b), generator=gen) < 1 / 32).float()
          for a, b in zip(widths[:-1], widths[1:])]
    g = torch.randint(-2, 3, (rows, widths[-1]), generator=gen).float()
    return x.to(device, dtype), [w.to(device, dtype) for w in ws], g.to(device, dtype)
