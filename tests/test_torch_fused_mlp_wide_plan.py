"""The wide fused-MLP kernels' host side on the CPU: the launch plan
(ops/cuda/fused_mlp.py::wide_plan: scratch planes, row splits), the bf16 hi/lo arithmetic of the dW product emulated in torch
against the plain backward, and the build key that names a compiled
library (ops/cuda/_build.py). The kernels themselves run in
test_torch_cuda_kernels.py on a GPU."""
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import _build
from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

torch.set_num_threads(1)

# the chains the CUDA tests run (tests/test_torch_cuda_kernels.py::WIDE)
WIDE = [(64,) + (257,) * 8, (48, 96, 80, 16), (16, 272, 272, 3), (272, 272)]
ROWS = [1, 63, 64, 65, 127, 128, 129, 1000, 132 * 128 + 1, 20000, 113181, 131072]


def _plan(widths, rows, dtype=torch.bfloat16, **kw):
    return fm.wide_plan(fm.padded_widths(widths), rows, dtype, **kw)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("widths", WIDE)
def test_scratch_planes_tile_the_allocation(widths, rows):
    """The planes the wrapper hands the kernels are disjoint views that
    fill exactly the scratch it allocates (plan.scratch_elems), each of
    whole 128-row tiles covering the rows, in the order the C side takes."""
    plan = _plan(widths, rows)
    padded = fm.padded_widths(widths)
    n = len(padded) - 1
    assert plan.plane_rows % fm.WIDE_TILE_ROWS == 0
    assert plan.plane_rows >= rows > plan.plane_rows - fm.WIDE_TILE_ROWS
    scratch = torch.empty(plan.scratch_elems, dtype=torch.bfloat16)
    assert scratch.numel() * scratch.element_size() == plan.scratch_bytes
    views = fm.wide_planes(plan, scratch)
    assert len(views) == 4 * n
    assert views[3 * n - 1] is None and views[3 * n] is None  # top g_lo, x's bits
    spans = sorted((v.data_ptr(), v.data_ptr() + 2 * v.numel())
                   for v in views if v is not None)
    assert spans[0][0] == scratch.data_ptr()
    assert spans[-1][1] == scratch.data_ptr() + plan.scratch_bytes
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # disjoint, no gaps
    widths_of = padded[:-1] + padded[1:] + padded[1:-1] + [None]
    for v, w in zip(views, widths_of):
        if v is not None and w is not None:
            assert v.numel() == plan.plane_rows * w
    words = fm.WIDE_BIT_WORDS * fm.WIDE_THREADS_PER_GROUP * plan.plane_rows // fm.WIDE_BLOCK_ROWS
    assert plan.bit_words == words  # the size the C entry checks
    assert all(v.numel() == 2 * words for v in views[3 * n + 1:])
    assert all(p[1] * 2 % 16 == 0 for p in plan.planes)  # bulk copies: 16-byte aligned


@pytest.mark.parametrize("sms", [132, 114, 78, 66, 16, 8, 2, 1])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("widths", WIDE)
def test_row_splits_cover_every_row_once(widths, rows, sms):
    """The dW kernel's row splits (blockIdx.y takes 64-row blocks
    [s * per, (s + 1) * per)) cover every row exactly once and none is
    empty, in at most WIDE_DW_WAVES waves of the device's SMs; the chain
    kernels take at most one CTA per SM and per tile."""
    plan = _plan(widths, rows, sms=sms)
    blocks = -(-rows // fm.WIDE_BLOCK_ROWS)
    per = plan.dw_split_rows // fm.WIDE_BLOCK_ROWS
    assert plan.dw_split_rows % fm.WIDE_BLOCK_ROWS == 0
    covered = np.zeros(blocks, dtype=int)
    for s in range(plan.dw_splits):
        lo, hi = s * per, min(blocks, (s + 1) * per)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    rows_of = np.zeros(blocks * fm.WIDE_BLOCK_ROWS, dtype=int)
    for s in range(plan.dw_splits):
        rows_of[s * plan.dw_split_rows:(s + 1) * plan.dw_split_rows] += 1
    assert (rows_of[:rows] == 1).all()
    n = len(widths) - 1
    assert plan.dw_slices == max(-(-d // fm.WIDE_DW_SLICE) for d in fm.padded_widths(widths)[:-1])
    assert plan.partial_floats == plan.dw_splits * sum(
        a * b for a, b in zip(fm.padded_widths(widths)[:-1], fm.padded_widths(widths)[1:]))
    assert plan.dw_splits <= max(1, fm.WIDE_DW_WAVES * sms // (plan.dw_slices * n))
    assert 1 <= plan.chain_ctas <= min(sms, -(-rows // fm.WIDE_TILE_ROWS))


def test_f32_plan_takes_the_tf32_kernels_shape():
    """OriginNeRF's chain at its train step in f32: the bf16 plan's launch
    shape, post and g planes in f32 (no lo planes: the dW kernel splits g
    itself), bit planes of 12 words a row, and 4.3 MB of the forward's
    weights split for the tensor cores."""
    plan = _plan((64,) + (257,) * 8, 131072, torch.float32)
    assert plan.chain_ctas == 132 and plan.dw_slices == 3 and plan.dw_splits == 22
    assert [p[0] for p in plan.planes] == ([f"post{i}" for i in range(8)]
                                           + [f"g{i}" for i in range(8)]
                                           + [f"bits{i}" for i in range(1, 8)])
    assert plan.scratch_elems == 131072 * (64 + 7 * 272 + 8 * 272 + 7 * 12)
    assert plan.prep_floats == 64 // 8 * 16 * 272 + 7 * 34 * 16 * 272


@pytest.mark.parametrize("value", [float("inf"), float("-inf"), float("nan"), 3.4e38, -3.4e38])
def test_split_bf16_carries_a_non_finite_head_alone(value):
    g = torch.tensor([value, 1.0 + 2.0 ** -12], dtype=torch.float32)
    hi, lo = fm.split_bf16(g)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert not torch.isfinite(hi[0]) and lo[0].item() == 0.0
    assert hi[1].item() == 1.0 and lo[1].item() == 2.0 ** -12


def _split_backward(x, weights, g):
    """The wide kernels' backward arithmetic in torch: the Pallas steps
    (fused_mlp_backward_reference), with each dW formed as the dW kernel
    forms it, post^T g_hi + post^T g_lo of bf16 operands accumulated in
    f32, from the unrounded gradient split by split_bf16."""
    acc = torch.float32
    post = [x]
    for w in weights[:-1]:
        post.append(torch.relu(post[-1].to(acc) @ w.to(acc)).to(x.dtype))
    g = g.to(x.dtype).to(acc)
    dws = [None] * len(weights)
    for i in range(len(weights) - 1, -1, -1):
        hi, lo = fm.split_bf16(g)
        p = post[i].to(acc)
        dws[i] = p.T @ hi.to(acc) + p.T @ lo.to(acc)
        g = g.to(x.dtype).to(acc) @ weights[i].to(acc).T
        if i > 0:
            g = g * (post[i].to(acc) > 0.0)
    return dws


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("widths", [(64, 272, 272, 272), (48, 96, 80, 16), (16, 64, 3)])
def test_hi_lo_dw_matches_the_plain_backward(widths, seed):
    """post^T g_hi + post^T g_lo (bf16 products, f32 sums) keeps about 16
    of g's 24 mantissa bits: within 2^-15 of the plain backward's f32 dW
    (its weights in f32, so that it returns dW unrounded) over each
    tensor's norm, on random bf16 inputs."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((512, widths[0])).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(widths[:-1], widths[1:])]
    g = torch.from_numpy(rng.standard_normal((512, widths[-1])).astype(np.float32))
    x, g = x.bfloat16(), g.bfloat16()
    ws = [w.bfloat16().float() for w in ws]
    _, ref = fm.fused_mlp_backward_reference(x, ws, g)
    emu = _split_backward(x, ws, g)
    for a, b in zip(emu, ref):
        assert b.dtype == torch.float32
        assert (a - b).norm() <= 2.0 ** -15 * b.norm()


def test_hi_lo_dw_keeps_non_finite_gradients():
    """A non-finite gradient reaches dW as in the plain backward: its head
    carries it and its rest is 0."""
    x = torch.ones((4, 16), dtype=torch.bfloat16)
    ws = [torch.full((16, 16), 0.25), torch.full((16, 16), 0.25)]
    g = torch.ones((4, 16), dtype=torch.bfloat16)
    g[1, 2] = float("inf")
    g[2, 3] = float("nan")
    _, ref = fm.fused_mlp_backward_reference(x, ws, g)
    emu = _split_backward(x, ws, g)
    for a, b in zip(emu, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))


def _sources(tmp_path):
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "inc/b.cuh"\nint a;\n')
    (tmp_path / "inc" / "b.cuh").write_text('#pragma once\n#include "../a.cuh"\nint b;\n')
    return tmp_path / "k.cu"


def test_build_key_follows_included_headers(tmp_path):
    src = _sources(tmp_path)
    assert [p.name for p in _build.sources(src)] == ["k.cu", "a.cuh", "b.cuh"]
    flags = _build.NVCC_FLAGS
    key = _build.build_key(src, flags)
    assert key == _build.build_key(src, flags)  # stable
    (tmp_path / "inc" / "b.cuh").write_text('#pragma once\n#include "../a.cuh"\nint b2;\n')
    key_b = _build.build_key(src, flags)
    assert key_b != key  # a nested header changed
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "inc/b.cuh"\nint a2;\n')
    assert _build.build_key(src, flags) not in (key, key_b)
    assert _build.build_key(src, (*flags, "-lineinfo")) != _build.build_key(src, flags)


def test_build_key_of_the_fused_mlp_source_covers_hopper_cuh():
    names = [p.name for p in _build.sources(fm.SOURCE)]
    assert names == ["fused_mlp.cu", "hopper.cuh"]
