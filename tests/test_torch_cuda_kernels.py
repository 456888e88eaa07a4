"""The port's CUDA kernels on a GPU, against their plain PyTorch versions:
the fused MLP forward and backward, and the NGP model (MLP and grid-encode
kernels) and its gradient.

Every test here needs an NVIDIA GPU and nvcc and skips without one. This
file imports no JAX, so on a machine without it run:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm
from myc_nerfs_tpu_torch.utils import profiling


def launches(kernel: str) -> int:
    """The registry's launch count of ``kernel`` (utils/profiling.py)."""
    return profiling.counts(traced=False)[f"launch.{kernel}"]


torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _net(widths, rows, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.standard_normal((widths[i], widths[i + 1]))
                            / np.sqrt(widths[i])).astype(np.float32))
          .to(device, dtype) for i in range(len(widths) - 1)]
    x = torch.from_numpy(rng.standard_normal((rows, widths[0]))
                         .astype(np.float32)).to(device, dtype)
    return x, ws


# rows: ragged 16-row strips and 32-row warp chunks on both sides of each
# boundary, and one 4096-ray x 64-sample chunk
ROWS = [1, 15, 16, 17, 63, 64, 65, 1000, 70001, 262144]


# f32: the same products summed in another order (1e-5 of the scale);
# bf16: every layer rounds to bf16, a sum on the other side of a rounding
# boundary moves an intermediate by one ulp (2 ulps, 2^-7, of the scale)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("widths", [(32, 64, 16), (32, 64, 64, 16),
                                    (16, 32, 48, 64, 16)])
@pytest.mark.parametrize("rows", ROWS)
def test_fused_mlp_matches_plain(cuda_device, widths, dtype, rtol, rows):
    x, ws = _net(widths, rows, dtype, cuda_device)
    before = launches("fused_mlp")
    with torch.no_grad():
        out = fm.fused_mlp(x, ws)
        ref = fm.fused_mlp_reference(x, ws)
    torch.cuda.synchronize()
    assert launches("fused_mlp") == before + 1
    assert out.dtype == dtype and out.shape == (rows, widths[-1])
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


def test_fused_mlp_refuses_what_the_kernel_does_not_take(cuda_device):
    # widths that are not multiples of 16 are padded (test_fused_mlp_pads_
    # to_the_kernels_widths); a width above 272 is refused
    x, ws = _net((32, 288, 16), 10, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="up to 272"):
        fm.fused_mlp(x, ws)
    x, ws = _net((32, 64, 16), 10, torch.float16, cuda_device)
    with pytest.raises(TypeError):
        fm.fused_mlp(x, ws)
    x, ws = _net((32, 16), 10, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="device and dtype"):
        fm.fused_mlp(x, [ws[0].cpu()])
    # a chain whose backward needs more shared memory than a CTA has: the
    # forward runs, the backward raises
    for dtype in (torch.float32, torch.bfloat16):
        x, ws = _net((64,) * 9, 10, dtype, cuda_device)
        y = fm.fused_mlp(x.requires_grad_(), ws)
        with pytest.raises(ValueError, match="shared memory"):
            y.float().sum().backward()


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("widths", [(32, 64, 8), (30, 50, 3), (16, 33, 33)])
def test_fused_mlp_pads_to_the_kernels_widths(cuda_device, widths, dtype, rtol):
    """Widths that are not multiples of 16 run padded (zero rows and
    columns) and come back sliced: y, dx and each dW against the plain
    versions on the unpadded chain."""
    x, ws = _net(widths, 1000, dtype, cuda_device)
    g = _grad_out(1000, widths[-1], dtype, cuda_device)
    with torch.no_grad():
        y, ref = fm.fused_mlp(x, ws), fm.fused_mlp_reference(x, ws)
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    torch.cuda.synchronize()
    for a, b in [(y, ref), (dx, dx_ref)] + list(zip(dws, dws_ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max().item() <= \
            (rtol if dtype == torch.bfloat16 else 1e-4) * max(1.0, b.float().abs().max().item())


WIDE = [(64,) + (257,) * 8, (48, 96, 80, 16), (16, 272, 272, 3), (272, 272)]
# rows: one 64-row block of a consumer warpgroup on both sides, a 128-row
# tile on both sides, and one row past a whole wave of the persistent grid
# (132 SMs x 128 rows)
WIDE_ROWS = [1, 63, 64, 65, 127, 128, 129, 1000, 132 * 128 + 1, 131072]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("widths", WIDE)
@pytest.mark.parametrize("rows", WIDE_ROWS)
def test_fused_mlp_wide_matches_plain(cuda_device, widths, dtype, rtol, rows):
    """Chains above 64 wide take the wide kernel (its counter, not the
    narrow one's): random inputs, as test_fused_mlp_matches_plain."""
    x, ws = _net(widths, rows, dtype, cuda_device)
    before = launches("fused_mlp_wide"), launches("fused_mlp")
    with torch.no_grad():
        out = fm.fused_mlp(x, ws)
        ref = fm.fused_mlp_reference(x, ws)
    torch.cuda.synchronize()
    assert (launches("fused_mlp_wide"), launches("fused_mlp")) == (before[0] + 1, before[1])
    assert out.dtype == dtype and out.shape == (rows, widths[-1])
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", WIDE)
@pytest.mark.parametrize("rows", WIDE_ROWS)
def test_fused_mlp_wide_backward_exact_inputs(cuda_device, widths, dtype, rows):
    """On fm.exact_inputs (integers: every sum exact, so any order gives
    the same bits): y, dx and every dW equal to the plain versions' bits."""
    x, ws, g = fm.exact_inputs(widths, rows, dtype, cuda_device)
    before = launches("fused_mlp_wide_bwd")
    with torch.no_grad():
        y, y_ref = fm.fused_mlp(x, ws), fm.fused_mlp_reference(x, ws)
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    torch.cuda.synchronize()
    assert launches("fused_mlp_wide_bwd") == before + 1
    assert torch.equal(y, y_ref) and torch.equal(dx, dx_ref)
    for a, b in zip(dws, dws_ref):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("widths", WIDE)
@pytest.mark.parametrize("rows", [127, 1000, 70001])
def test_fused_mlp_wide_backward_matches_plain_f32(cuda_device, widths, rows):
    """Random f32 inputs: dx 1e-5 and dW 1e-4 of scale (BWD_TOL). In bf16
    random inputs put some pre-activation within a rounding of 0, where
    any two summation orders disagree on the ReLU mask (the exact-input
    test above holds the bf16 kernels instead)."""
    x, ws = _net(widths, rows, torch.float32, cuda_device)
    g = _grad_out(rows, widths[-1], torch.float32, cuda_device)
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    torch.cuda.synchronize()
    tol_dx, tol_dw = BWD_TOL[torch.float32]
    for i, (a, b) in enumerate([(dx, dx_ref)] + list(zip(dws, dws_ref))):
        tol = tol_dx if i == 0 else tol_dw
        assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


def test_fused_mlp_wide_backward_is_deterministic_and_skips_dx(cuda_device):
    x, ws = _net((64,) + (257,) * 8, 20000, torch.bfloat16, cuda_device)
    g = _grad_out(20000, 257, torch.bfloat16, cuda_device)
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx2, dws2 = fm.fused_mlp_backward(x, ws, g)
    none, dws3 = fm.fused_mlp_backward(x, ws, g, need_dx=False)
    assert none is None and torch.equal(dx, dx2)
    assert all(map(torch.equal, dws, dws2)) and all(map(torch.equal, dws, dws3))


def test_fused_mlp_wide_f32_backward_is_deterministic_and_skips_dx(cuda_device):
    """The f32 wide backward (CUDA-core chains, 3xTF32 dW, fixed-order sum
    of the row splits) gives the same bits twice, and the same dW without
    dx."""
    x, ws = _net((64,) + (257,) * 8, 20000, torch.float32, cuda_device)
    g = _grad_out(20000, 257, torch.float32, cuda_device)
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx2, dws2 = fm.fused_mlp_backward(x, ws, g)
    none, dws3 = fm.fused_mlp_backward(x, ws, g, need_dx=False)
    assert none is None and torch.equal(dx, dx2)
    assert all(map(torch.equal, dws, dws2)) and all(map(torch.equal, dws, dws3))


@pytest.mark.parametrize("widths", WIDE)
def test_fused_mlp_wide_f32_keeps_non_finite(cuda_device, widths):
    """On the f32 wide path a quiet NaN, a NaN whose payload lies in the low
    13 bits alone (0x7f800001: a TF32 read that cleared them would make it
    inf) and an inf, in x and in g: y has the plain forward's NaN and inf
    elements, dx and every dW its non-finite elements (an inf may read NaN
    there: 3xTF32 dW is three products)."""
    rows = 1000
    x, ws = _net(widths, rows, torch.float32, cuda_device)
    g = _grad_out(rows, widths[-1], torch.float32, cuda_device)
    for t in (x, g):
        t[17, 1] = float("nan")
        t.view(torch.int32)[500, 2] = 0x7F800001
        t[999, 0] = float("inf")
    with torch.no_grad():
        y, ref = fm.fused_mlp(x, ws), fm.fused_mlp_reference(x, ws)
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    assert torch.equal(torch.isinf(y), torch.isinf(ref))
    assert (~torch.isfinite(y[[17, 500, 999]])).any(1).all()  # every planted row
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    for a, b in zip([dx] + dws, [dx_ref] + dws_ref):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", WIDE)
def test_fused_mlp_wide_keeps_nan(cuda_device, widths, dtype):
    """test_fused_mlp_keeps_nan on the wide kernels: a NaN in x comes out
    NaN in the same rows of y and nowhere else; a NaN in g comes out NaN in
    the same rows of dx; dx and every dW have the plain version's NaN
    pattern."""
    rows = 1000
    x, ws = _net(widths, rows, dtype, cuda_device)
    bad = torch.tensor([0, 17, 500, 999], device=cuda_device)
    x[bad, 3] = float("nan")
    with torch.no_grad():
        y = fm.fused_mlp(x, ws)
    assert torch.isnan(y[bad]).all()
    assert torch.equal(torch.isnan(y).any(1).nonzero().flatten(), bad)
    g = _grad_out(rows, widths[-1], dtype, cuda_device)
    g_bad = torch.tensor([3, 400], device=cuda_device)
    g[g_bad, 0] = float("nan")
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    assert torch.isnan(dx[g_bad]).all()
    for a, b in zip([dx] + dws, [dx_ref] + dws_ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))


@pytest.mark.parametrize("use_bf16", [False, True])
def test_ori_nerf_fused_on_gpu_matches_cpu(cuda_device, use_bf16):
    """OriginNeRFModel(use_fused) at D=8, W=256: the backbone through the
    wide kernels on the card against the same weights on the CPU through
    the plain versions, forward and every parameter's gradient. f32 1e-4 of
    scale; bf16 2^-5 of scale over the norm (mask flips, see above)."""
    from myc_nerfs_tpu_torch.models import ori_nerf

    cfg = ori_nerf.OriginNeRFConfig(skips=(), use_fused=True, use_bf16=use_bf16)
    cpu = ori_nerf.OriginNeRFModel(cfg, generator=torch.Generator().manual_seed(0))
    gpu = ori_nerf.OriginNeRFModel(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.uniform(0, 1, (4000, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.uniform(0, 1, (4000, 3)).astype(np.float32))
    before = launches("fused_mlp_wide"), launches("fused_mlp_wide_bwd")
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        out = model(pos.to(dev), dirs.to(dev))
        grads = torch.autograd.grad((out ** 2).sum(), model.param_list())
        outs.append([out.detach().float().cpu()] + [g.float().cpu() for g in grads])
    assert (launches("fused_mlp_wide"), launches("fused_mlp_wide_bwd")) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(outs[1], outs[0]):
        if use_bf16:
            assert (a - b).norm() <= 2.0 ** -5 * b.norm().clamp_min(1e-6)
        else:
            assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-6)


def test_ngp_model_on_gpu_matches_cpu(cuda_device):
    """The NGP model with its MLPs and brick3 encode through the kernels on
    the card against the same weights on the CPU through the plain
    versions (f32; SH runs as torch ops on both)."""
    from myc_nerfs_tpu_torch.models import ngp

    cfg = ngp.NGPModelConfig(grid=ngp.HashGridConfig(
        n_levels=8, log2_hashmap_size=15, desired_resolution=256.0))
    cpu = ngp.NGPModel(cfg, generator=torch.Generator().manual_seed(0))
    gpu = ngp.NGPModel(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    before = launches("fused_mlp"), launches("brick_encode")
    with torch.no_grad():
        ref = cpu(pos, dirs)
        out = gpu(pos.to(cuda_device), dirs.to(cuda_device)).cpu()
    # density and rgb MLPs, one encode
    assert (launches("fused_mlp"), launches("brick_encode")) == (before[0] + 2,
                                                                 before[1] + 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def _grad_out(rows, width, dtype, device, seed=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rows, width))
                            .astype(np.float32)).to(device, dtype)


# Tolerances, against the scale (max abs, at least 1) of each reference:
# f32 dx 1e-5 (sums of 16-64 products in another order); f32 dW 1e-4 (a sum
# over up to 70001 rows in another order); bf16 2 ulps (2^-7): a sum on the
# other side of a rounding boundary moves a rounded gradient or
# post-activation by one ulp.
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}


# (64, 64, 64, 64) has 96 dW tiles of 16x8: the bf16 kernel runs two passes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(32, 64, 16), (32, 64, 64, 16), (16, 32, 48, 64, 16),
                                    (64, 64, 64, 64)])
@pytest.mark.parametrize("rows", ROWS)
def test_fused_mlp_backward_matches_plain(cuda_device, widths, dtype, rows):
    x, ws = _net(widths, rows, dtype, cuda_device)
    g = _grad_out(rows, widths[-1], dtype, cuda_device)
    before = launches("fused_mlp_bwd")
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    torch.cuda.synchronize()
    assert launches("fused_mlp_bwd") == before + 1
    tol_dx, tol_dw = BWD_TOL[dtype]
    assert dx.dtype == dtype and dx.shape == x.shape
    scale = max(1.0, dx_ref.float().abs().max().item())
    assert (dx.float() - dx_ref.float()).abs().max().item() <= tol_dx * scale
    for dw, ref, w in zip(dws, dws_ref, ws):
        assert dw.dtype == dtype and dw.shape == w.shape
        scale = max(1.0, ref.float().abs().max().item())
        assert (dw.float() - ref.float()).abs().max().item() <= tol_dw * scale
    # the partial dWs are summed in a fixed order: the same bits every run
    dx2, dws2 = fm.fused_mlp_backward(x, ws, g)
    assert torch.equal(dx, dx2) and all(map(torch.equal, dws, dws2))


def test_fused_mlp_autograd_on_gpu(cuda_device):
    """fused_mlp under autograd on the card launches both kernels, honours
    needs_input_grad, and gives the CPU plain path's gradients (f32)."""
    x, ws = _net((32, 64, 64, 16), 5000, torch.float32, cuda_device)
    g = _grad_out(5000, 16, torch.float32, cuda_device)
    grads = {}
    for dev in ("cuda", "cpu"):
        xs = x.detach().to(dev).requires_grad_()
        wss = [w.detach().to(dev).requires_grad_() for w in ws]
        f0, b0 = launches("fused_mlp"), launches("fused_mlp_bwd")
        (fm.fused_mlp(xs, wss) * g.to(dev)).sum().backward()
        launched = (launches("fused_mlp") - f0, launches("fused_mlp_bwd") - b0)
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
        grads[dev] = [xs.grad.cpu()] + [w.grad.cpu() for w in wss]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, b.abs().max().item()))
    # weights only: no dx is asked for, and none is made
    wss = [w.detach().requires_grad_() for w in ws]
    (fm.fused_mlp(x, wss) * g).sum().backward()
    assert all(w.grad is not None for w in wss)


def test_ngp_model_gradient_on_gpu_matches_cpu(cuda_device):
    """The gradient of every NGPModel parameter (tables and MLP weights), on
    the card through the MLP and encode kernels, forward and backward,
    against the CPU through the plain versions (f32). The table gradient
    is the encode kernel's scatter-add, whose atomics sum in no fixed
    order, of contributions that carry the MLP kernels' own summation
    order: rtol 1e-4 against each tensor's scale."""
    from myc_nerfs_tpu_torch.models import ngp

    cfg = ngp.NGPModelConfig(grid=ngp.HashGridConfig(
        n_levels=8, log2_hashmap_size=15, desired_resolution=256.0))
    cpu = ngp.NGPModel(cfg, generator=torch.Generator().manual_seed(0))
    gpu = ngp.NGPModel(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((5000, 4)).astype(np.float32))
    before = launches("fused_mlp_bwd"), launches("brick_encode_bwd")
    ((cpu(pos, dirs) - tgt) ** 2).sum().backward()
    ((gpu(pos.to(cuda_device), dirs.to(cuda_device)) - tgt.to(cuda_device))
     ** 2).sum().backward()
    # density and rgb MLPs, one encode
    assert (launches("fused_mlp_bwd"),
            launches("brick_encode_bwd")) == (before[0] + 2, before[1] + 1)
    for (name, a), (_, b) in zip(gpu.named_parameters(), cpu.named_parameters()):
        scale = max(1e-6, b.grad.abs().max().item())
        err = (a.grad.cpu() - b.grad).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(32, 64, 16), (32, 64, 64, 16)])
def test_fused_mlp_keeps_nan(cuda_device, widths, dtype):
    """A NaN in x comes out NaN in the same rows of y and nowhere else (the
    ReLU keeps it); a NaN in g comes out NaN in the same rows of dx; and
    dx and every dW have the plain version's NaN pattern."""
    rows = 1000
    x, ws = _net(widths, rows, dtype, cuda_device)
    bad = torch.tensor([0, 17, 500, 999], device=cuda_device)
    x[bad, 3] = float("nan")
    with torch.no_grad():
        y = fm.fused_mlp(x, ws)
    assert torch.isnan(y[bad]).all()
    assert torch.equal(torch.isnan(y).any(1).nonzero().flatten(), bad)
    g = _grad_out(rows, widths[-1], dtype, cuda_device)
    g_bad = torch.tensor([3, 400], device=cuda_device)
    g[g_bad, 0] = float("nan")
    dx, dws = fm.fused_mlp_backward(x, ws, g)
    dx_ref, dws_ref = fm.fused_mlp_backward_reference(x, ws, g)
    assert torch.isnan(dx[g_bad]).all()
    for a, b in zip([dx] + dws, [dx_ref] + dws_ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_rgb_head_dw_is_zero(cuda_device, dtype):
    """The rgb head is padded from 3 to 16 columns with zeros and only its
    first 3 outputs are used (models/ngp.py): dW columns 3..15 come out
    exactly 0, the others do not."""
    rows = 70001
    x, ws = _net((32, 64, 64, 16), rows, dtype, cuda_device)
    ws[2][:, 3:] = 0
    ws = [w.requires_grad_() for w in ws]
    y = fm.fused_mlp(x, ws)[:, :3]
    (y.float() * _grad_out(rows, 3, torch.float32, cuda_device)).sum().backward()
    assert torch.equal(ws[2].grad[:, 3:], torch.zeros_like(ws[2].grad[:, 3:]))
    assert (ws[2].grad[:, :3] != 0).all()
