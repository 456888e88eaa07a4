"""The wide f32 fused-MLP kernels' arithmetic on the CPU: the TF32 split
of every operand (ops/cuda/fused_mlp.py::split_tf32), the torch emulation of
the kernels' three-pass (3xTF32) products (forward_3xtf32, backward_3xtf32:
the forward's and dW's; the backward's recompute and dgrad run f32 on the
CUDA cores) against the plain forward and backward, the two planted faults
the card's f32 check must see,
and the f32 launch plan (wide_plan). The kernels themselves run in
test_torch_cuda_kernels.py on a GPU."""
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

torch.set_num_threads(1)

# chip_smoke.py's f32 limits: forward 1e-4 of the output's scale; backward
# dx 1e-5, dW 1e-4 of each tensor's scale
FWD_TOL = 1e-4
BWD_TOL = (1e-5, 1e-4)
CHAINS = [(64, 272, 272, 272), (48, 96, 80, 16), (16, 64, 3)]


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.int32)


def _inputs(widths, rows, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (rows, widths[0])).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(widths[:-1], widths[1:])]
    g = torch.from_numpy(rng.standard_normal((rows, widths[-1])).astype(np.float32))
    return x, ws, g


def _fwd_err(y, ref):
    return (y - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def _bwd_errs(dx, dws, dx_ref, dws_ref):
    """(dx, largest dW) max-abs error, each over its reference's scale."""
    errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
            for a, b in zip([dx] + dws, [dx_ref] + dws_ref)]
    return errs[0], max(errs[1:])


def test_split_tf32_head_and_rest():
    """big has its low 13 bits clear and big + small rebuilds v to within
    2^-21 of |v|, over 60 binades of both signs; small is a TF32 value."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(200000)
                          * 2.0 ** rng.integers(-30, 30, 200000)).astype(np.float32))
    big, small = fm.split_tf32(v)
    assert not (_bits(big) & 0x1FFF).any() and not (_bits(small) & 0x1FFF).any()
    err = (big.double() + small.double() - v.double()).abs()
    assert (err <= 2.0 ** -21 * v.double().abs()).all()
    assert (big.abs() <= v.abs()).all()  # big is v cut toward zero


@pytest.mark.parametrize("bits", [0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0xFF800001,
                                  0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F0000])
def test_split_tf32_keeps_the_kind_of_a_value(bits):
    """inf, -inf, a quiet NaN, NaNs whose payload is only in the low 13
    bits (cleared, they would read inf), and values near f32's largest keep
    their kind; a non-finite big carries the value alone (small 0)."""
    v = torch.tensor([bits - (1 << 32) if bits >= 1 << 31 else bits],
                     dtype=torch.int32).view(torch.float32)
    big, small = fm.split_tf32(v)
    assert torch.isnan(big).item() == torch.isnan(v).item()
    assert torch.isinf(big).item() == torch.isinf(v).item()
    if torch.isfinite(v).item():
        assert torch.isfinite(small).item() and big.item() + small.item() == pytest.approx(v.item(), rel=2.0 ** -21)
        assert (big.item() > 0) == (v.item() > 0)
    else:
        assert small.item() == 0.0
        if torch.isinf(v).item():
            assert big.item() == v.item()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("widths", CHAINS)
def test_three_pass_products_match_the_plain_versions(widths, seed):
    """The 3xTF32 emulation stays within chip_smoke's f32 limits of
    fused_mlp_reference and fused_mlp_backward_reference on random
    inputs: f32-level error, though each pass sees 11 significant bits."""
    x, ws, g = _inputs(widths, 512, seed)
    assert _fwd_err(fm.forward_3xtf32(x, ws), fm.fused_mlp_reference(x, ws)) <= FWD_TOL
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    dx_err, dw_err = _bwd_errs(*fm.backward_3xtf32(x, ws, g), dx_ref, dws_ref)
    assert dx_err <= BWD_TOL[0] and dw_err <= BWD_TOL[1]


@pytest.mark.parametrize("fault", ["one_pass", "no_small_a"])
@pytest.mark.parametrize("widths", CHAINS[:2])
def test_planted_tf32_faults_fall_outside_the_limits(widths, fault):
    """A kernel that took one TF32 pass, or dropped the small(a) big(b)
    term, would read beyond the f32 limits in the forward and in dW: the
    random-input check on the card can see either."""
    x, ws, g = _inputs(widths, 512, 0)
    assert _fwd_err(fm.forward_3xtf32(x, ws, fault), fm.fused_mlp_reference(x, ws)) > FWD_TOL
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    dx_err, dw_err = _bwd_errs(*fm.backward_3xtf32(x, ws, g, fault=fault), dx_ref, dws_ref)
    assert dx_err <= BWD_TOL[0] < BWD_TOL[1] < dw_err


def test_three_pass_products_keep_non_finite_values():
    """An inf or NaN in x (a NaN with only low payload bits too) reaches y
    as in the plain forward, also through weights that TF32 holds exactly
    (small 0: inf times it would be NaN without fin)."""
    x, ws, _ = _inputs((16, 64), 64, 3)
    ws = [torch.round(w * 8) / 8 for w in ws]  # exact in TF32: small(w) = 0, some w = 0
    x[3, 2] = float("inf")
    x.view(torch.int32)[9, 5] = 0x7F800001
    x[20, 1] = float("-inf")
    y, ref = fm.forward_3xtf32(x, ws), fm.fused_mlp_reference(x, ws)
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    assert torch.equal(torch.isinf(y), torch.isinf(ref))
    assert torch.isinf(ref).any() and torch.isnan(ref).any()


def _plan(widths, rows, **kw):
    return fm.wide_plan(fm.padded_widths(widths), rows, torch.float32, **kw)


WIDE = [(64,) + (257,) * 8, (48, 96, 80, 16), (16, 272, 272, 3), (272, 272)]


@pytest.mark.parametrize("rows", [1, 64, 129, 1000, 132 * 128 + 1, 131072])
@pytest.mark.parametrize("widths", WIDE)
def test_f32_plan_scratch_tiles_the_allocation(widths, rows):
    """The f32 planes (post_0.., g_0.., bits_1..: fused_mlp_wide_bwd_f32's
    order) are disjoint 16-byte aligned views that fill the scratch, each
    of whole 128-row tiles; prep holds each layer's W^T as big and
    small planes padded to the wgmma's N (the forward's B)."""
    plan = _plan(widths, rows)
    padded = fm.padded_widths(widths)
    n = len(padded) - 1
    assert plan.plane_rows % fm.WIDE_TILE_ROWS == 0
    assert plan.plane_rows >= rows > plan.plane_rows - fm.WIDE_TILE_ROWS
    scratch = torch.empty(plan.scratch_elems, dtype=torch.float32)
    assert scratch.numel() * 4 == plan.scratch_bytes
    views = fm.wide_planes(plan, scratch)
    assert len(views) == 3 * n and views[2 * n] is None  # x has no bit plane
    spans = sorted((v.data_ptr(), v.data_ptr() + 4 * v.numel()) for v in views if v is not None)
    assert spans[0][0] == scratch.data_ptr()
    assert spans[-1][1] == scratch.data_ptr() + plan.scratch_bytes
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for v, w in zip(views[:2 * n], padded[:-1] + padded[1:]):
        assert v.numel() == plan.plane_rows * w
    words = fm.WIDE_F32_BIT_WORDS * fm.WIDE_F32_THREADS * plan.plane_rows // fm.WIDE_BLOCK_ROWS
    assert plan.bit_words == words  # the size the C entry checks
    assert all(v.numel() == words for v in views[2 * n + 1:])
    assert all(p[1] * 4 % 16 == 0 for p in plan.planes)
    pad = {16: 64, 48: 64, 64: 64, 80: 256, 96: 256, 272: 272}
    assert plan.prep_floats == sum(a // 8 * 16 * pad[b] for a, b in zip(padded[:-1], padded[1:]))
    # the backward's W^T of the layers below the top fit in the same room
    assert plan.prep_floats >= sum(a * b for a, b in zip(padded[:-2], padded[1:-1]))


@pytest.mark.parametrize("sms", [132, 78, 8, 1])
@pytest.mark.parametrize("rows", [1, 63, 65, 1000, 20000, 131072])
@pytest.mark.parametrize("widths", WIDE)
def test_f32_plan_splits_cover_every_row_once(widths, rows, sms):
    """The f32 dW kernel's row splits cover every 64-row block exactly
    once, none empty, in at most WIDE_DW_WAVES waves; the chain kernels
    take at most one CTA per SM and per tile (the bf16 plan's shape)."""
    plan = _plan(widths, rows, sms=sms)
    blocks = -(-rows // fm.WIDE_BLOCK_ROWS)
    per = plan.dw_split_rows // fm.WIDE_BLOCK_ROWS
    covered = np.zeros(blocks, dtype=int)
    for s in range(plan.dw_splits):
        lo, hi = s * per, min(blocks, (s + 1) * per)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    n = len(widths) - 1
    assert plan.dw_splits <= max(1, fm.WIDE_DW_WAVES * sms // (plan.dw_slices * n))
    assert 1 <= plan.chain_ctas <= min(sms, -(-rows // fm.WIDE_TILE_ROWS))
    bf16 = fm.wide_plan(fm.padded_widths(widths), rows, torch.bfloat16, sms=sms)
    assert (plan.chain_ctas, plan.dw_slices, plan.dw_splits, plan.dw_split_rows) == \
        (bf16.chain_ctas, bf16.dw_slices, bf16.dw_splits, bf16.dw_split_rows)
