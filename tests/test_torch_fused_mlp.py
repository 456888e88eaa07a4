"""Port parity: myc_nerfs_tpu_torch.ops.cuda.fused_mlp on the CPU, forward
and backward, against the JAX Pallas fused_mlp and its custom VJP
(interpret mode, as tests/test_pallas_kernels.py runs them). The CUDA
kernels themselves are tested in test_torch_cuda_kernels.py."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myc_nerfs_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm
from myc_nerfs_tpu_torch.utils import profiling


def launches(kernel: str) -> int:
    """The registry's launch count of ``kernel`` (utils/profiling.py)."""
    return profiling.counts(traced=False)[f"launch.{kernel}"]


torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(widths, seed, x_rows):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((widths[i], widths[i + 1])) / np.sqrt(widths[i]))
          .astype(np.float32) for i in range(len(widths) - 1)]
    x = rng.standard_normal((x_rows, widths[0])).astype(np.float32)
    return x, ws


def _jax(x, ws, dtype, tile):
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_mlp(jnp.asarray(x, dtype),
                            tuple(jnp.asarray(w, dtype) for w in ws), tile)
    return np.asarray(out.astype(jnp.float32))


def _torch(x, ws, dtype):
    out = fm.fused_mlp(torch.from_numpy(x).to(dtype),
                       [torch.from_numpy(w).to(dtype) for w in ws])
    assert out.dtype == dtype
    return out.float().numpy()


# rows that are not a multiple of the JAX tile (64) or of the kernel's
# 64-row tile
@pytest.mark.parametrize("widths,rows", [((32, 64, 64, 16), 300),
                                         ((16, 32, 8), 77)])
def test_f32_matches_jax(widths, rows):
    """f32: both sum the same products in f32, in another order (atol 1e-5
    on O(1) outputs)."""
    x, ws = _net(widths, 0, rows)
    np.testing.assert_allclose(_torch(x, ws, torch.float32),
                               _jax(x, ws, jnp.float32, 64), atol=1e-5)


@pytest.mark.parametrize("widths,rows", [((32, 64, 64, 16), 300),
                                         ((16, 32, 8), 77)])
def test_bf16_matches_jax(widths, rows):
    """bf16: products are exact in f32 and sums are f32 on both sides, then
    every layer rounds to bf16. A sum that lands on the other side of a
    rounding boundary moves an intermediate by one bf16 ulp, so allow two
    ulps (2^-7) of the output's scale."""
    x, ws = _net(widths, 1, rows)
    ref = _jax(x, ws, jnp.bfloat16, 64)
    out = _torch(x, ws, torch.bfloat16)
    assert np.abs(out - ref).max() <= 2.0 ** -7 * max(1.0, np.abs(ref).max())
    # and almost everywhere the two are bit-identical
    assert np.mean(out != ref) < 0.02


def test_rgb_head_column_padding():
    """The port runs the rgb head's width-3 last layer zero-padded to 16
    columns; the first 3 columns equal JAX's unpadded fused_mlp."""
    x, ws = _net((32, 64, 64, 3), 2, 130)
    ref = _jax(x, ws, jnp.float32, 64)
    ws_pad = ws[:-1] + [np.pad(ws[-1], ((0, 0), (0, 13)))]
    out = _torch(x, ws_pad, torch.float32)
    assert out.shape == (130, 16)
    np.testing.assert_allclose(out[:, :3], ref, atol=1e-5)
    np.testing.assert_array_equal(out[:, 3:], 0.0)


def test_wrapper_rejects_a_broken_chain():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, [torch.zeros(32, 64), torch.zeros(32, 16)])
    with pytest.raises(ValueError):
        fm.fused_mlp(torch.zeros(4, 2, 32), [torch.zeros(32, 16)])


def test_cpu_path_does_not_count_launches():
    before = launches("fused_mlp")
    x, ws = _net((16, 32, 16), 3, 10)
    _torch(x, ws, torch.float32)
    assert launches("fused_mlp") == before


def test_port_imports_no_jax():
    """Importing the whole port leaves jax out of sys.modules."""
    code = ("import sys, pkgutil, importlib, myc_nerfs_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import myc_nerfs_tpu_torch.cli.run_net\n"
            "import myc_nerfs_tpu_torch.cli.probe_grid\n"
            "import myc_nerfs_tpu_torch.ops.cuda.grid_encode\n"
            "import myc_nerfs_tpu_torch.ops.cuda.grid_probe\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'myc_nerfs_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=120)


def _jax_vjp(x, ws, g, dtype, tile=64):
    """dx and dWs of the Pallas fused_mlp (its _bwd_kernel) as f32 numpy."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, ws: jax_fused_mlp(x, ws, tile),
                         jnp.asarray(x, dtype),
                         tuple(jnp.asarray(w, dtype) for w in ws))
        dx, dws = vjp(jnp.asarray(g, dtype))
    return [np.asarray(a.astype(jnp.float32)) for a in (dx, *dws)]


def _torch_grads(x, ws, g, dtype):
    """dx and dWs through the autograd.Function (the CPU path runs
    fused_mlp_backward_reference), as f32 numpy."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = [torch.from_numpy(w).to(dtype).requires_grad_() for w in ws]
    fm.fused_mlp(xt, wt).backward(torch.from_numpy(g).to(dtype))
    for t in (xt, *wt):
        assert t.grad.dtype == dtype
    return [t.grad.float().numpy() for t in (xt, *wt)]


def _dead_units(x, ws):
    """Exact zeros in the ReLU masks: a zero input row and a first-layer
    unit whose weights are all zero (pre-activation exactly 0)."""
    x[3] = 0.0
    ws[0][:, 5] = 0.0
    return x, ws


@pytest.mark.parametrize("widths,rows", [((32, 64, 64, 16), 300),
                                         ((32, 64, 16), 77)])
def test_backward_f32_matches_jax_vjp(widths, rows):
    """f32: dx and every dW equal the Pallas VJP's to 1e-5 of each one's
    scale (the same products summed in another order; dW sums over all
    rows). Rows are not a multiple of the 64-row tile."""
    x, ws = _dead_units(*_net(widths, 4, rows))
    g = np.random.default_rng(5).standard_normal((rows, widths[-1])).astype(np.float32)
    ref = _jax_vjp(x, ws, g, jnp.float32)
    out = _torch_grads(x, ws, g, torch.float32)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()))
    # the dead unit passes no gradient back, on both sides
    assert np.all(out[1][:, 5] == 0.0) and np.all(ref[1][:, 5] == 0.0)


@pytest.mark.parametrize("widths,rows", [((32, 64, 64, 16), 300),
                                         ((32, 64, 16), 77)])
def test_backward_bf16_matches_jax_vjp(widths, rows):
    """bf16: the gradient is rounded to bf16 before each dgrad product and
    the post-activations are bf16 on both sides; a sum on the other side of
    a rounding boundary moves a value by one ulp, so allow two ulps (2^-7)
    of each one's scale."""
    x, ws = _dead_units(*_net(widths, 6, rows))
    g = np.random.default_rng(7).standard_normal((rows, widths[-1])).astype(np.float32)
    ref = _jax_vjp(x, ws, g, jnp.bfloat16)
    out = _torch_grads(x, ws, g, torch.bfloat16)
    for a, b in zip(out, ref):
        assert np.abs(a - b).max() <= 2.0 ** -7 * max(1.0, np.abs(b).max())


def test_backward_is_not_autograd_of_the_plain_forward():
    """In bf16 the autograd of fused_mlp_reference rounds the gradient at
    every layer boundary before dW; the port's backward, like the Pallas
    one, keeps dW's gradient in f32. The two differ; the port's equals
    JAX's bit for bit on this input."""
    x, ws = _net((32, 64, 64, 16), 8, 200)
    g = np.random.default_rng(9).standard_normal((200, 16)).astype(np.float32)
    ref = _jax_vjp(x, ws, g, jnp.bfloat16)
    dx, dws = fm.fused_mlp_backward(torch.from_numpy(x).bfloat16(),
                                    [torch.from_numpy(w).bfloat16() for w in ws],
                                    torch.from_numpy(g).bfloat16())
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = [torch.from_numpy(w).bfloat16().requires_grad_() for w in ws]
    fm.fused_mlp_reference(xt, wt).backward(torch.from_numpy(g).bfloat16())
    ported = [dx.float().numpy()] + [d.float().numpy() for d in dws]
    np.testing.assert_array_equal(ported[1], ref[1])
    assert any(not np.array_equal(a, t.grad.float().numpy())
               for a, t in zip(ported[1:], wt))


def test_backward_rgb_head_padding_matches_jax():
    """The port pads the rgb head's width-3 last layer to 16 columns; the
    autograd of F.pad drops the padded columns' gradient, and what is left
    equals JAX's unpadded VJP (f32, 1e-5 of scale)."""
    x, ws = _net((32, 64, 64, 3), 10, 130)
    g = np.random.default_rng(11).standard_normal((130, 3)).astype(np.float32)
    ref = _jax_vjp(x, ws, g, jnp.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    w2 = torch.nn.functional.pad(wt[2], (0, 13))
    y = fm.fused_mlp(xt, [wt[0], wt[1], w2])[:, :3]
    y.backward(torch.from_numpy(g))
    for t, b in zip((xt, *wt), ref):
        assert t.grad.shape == b.shape
        np.testing.assert_allclose(t.grad.numpy(), b, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_backward_gradcheck_f64():
    """The CPU path's backward is the derivative of its forward:
    torch.autograd.gradcheck in float64 (finite differences, its default
    tolerances), with only the weights asking for a gradient as well."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((23, 8))).requires_grad_()
    ws = [torch.from_numpy(rng.standard_normal(s)).requires_grad_()
          for s in ((8, 16), (16, 16), (16, 4))]
    assert torch.autograd.gradcheck(lambda x, *w: fm.fused_mlp(x, w), (x, *ws))
    assert torch.autograd.gradcheck(lambda *w: fm.fused_mlp(x.detach(), w), tuple(ws))


def test_backward_needs_input_grad():
    """No gradient is made for an input that does not ask for one."""
    x, ws = _net((16, 32, 16), 13, 20)
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    xt = torch.from_numpy(x)
    fm.fused_mlp(xt, wt).sum().backward()
    assert xt.grad is None and all(w.grad is not None for w in wt)
    dx, dws = fm.fused_mlp_backward(xt, wt, torch.ones(20, 16), need_dx=False)
    assert dx is None and len(dws) == 2



def test_plain_wrapper_runs_the_plain_versions_and_a_given_backward():
    """fused_mlp_plain: the plain forward and backward under autograd (on
    the CPU the same bits as fused_mlp); a backward passed to it is the one
    autograd runs."""
    x, ws = _net((16, 48, 32, 8), 14, 50)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = [torch.from_numpy(w).bfloat16().requires_grad_() for w in ws]
    g = torch.from_numpy(np.random.default_rng(15).standard_normal((50, 8))).bfloat16()
    y, yp = fm.fused_mlp(xt, wt), fm.fused_mlp_plain(xt, wt)
    assert torch.equal(y, yp)
    kernel_path = torch.autograd.grad(y, [xt] + wt, g)
    plain = torch.autograd.grad(yp, [xt] + wt, g)
    assert all(map(torch.equal, kernel_path, plain))
    calls = []

    def doubled(x, weights, g, need_dx=True):
        calls.append(need_dx)
        return fm.fused_mlp_backward_reference(x, weights, 2 * g, need_dx)

    twice = torch.autograd.grad(fm.fused_mlp_plain(xt, wt, backward=doubled), [xt] + wt, g)
    assert calls == [True] and all(torch.equal(a, 2 * b) for a, b in zip(twice, plain))


def test_exact_inputs_sum_alike_in_any_order_and_show_bf16_rounding():
    """exact_inputs at OriginNeRF's chain: the plain backward gives the
    same bits on the rows in another order (every sum is exact), and in
    bf16 it differs from the autograd of the plain forward, which rounds
    the gradient to bf16 before each dW (a backward without the lo term)."""
    widths = (64,) + (257,) * 8
    x, ws, g = fm.exact_inputs(widths, 2048, torch.bfloat16, "cpu", seed=5)
    dx, dws = fm.fused_mlp_backward_reference(x, ws, g)
    perm = torch.randperm(2048, generator=torch.Generator().manual_seed(1))
    dx_p, dws_p = fm.fused_mlp_backward_reference(x[perm], ws, g[perm])
    assert torch.equal(dx_p, dx[perm]) and all(map(torch.equal, dws_p, dws))
    wt = [w.clone().requires_grad_() for w in ws]
    rounded = torch.autograd.grad(fm.fused_mlp_reference(x, wt), wt, g)
    assert any(not torch.equal(a, b) for a, b in zip(rounded, dws))

# (widths, backward, dtype) -> (flops, bytes, bound in us, bound_by) at 262144
# rows: the H100 bounds of the NGP MLPs (bytes: x and y, or x, g and dx, plus
# the weights; flops: the function's, against 989 TFLOP/s bf16; f32-accurate
# products as three TF32 passes, 3 x flops at 495 TFLOP/s), and in f32 the
# CUDA cores' FMA bound (67 TFLOP/s) as bound_ms_fma
@pytest.mark.parametrize("widths,backward,dtype,expect", [
    ((32, 64, 16), False, torch.bfloat16, (1.611e9, 25.17e6, 7.51, "bytes")),
    ((32, 64, 64, 16), False, torch.bfloat16, (3.758e9, 25.18e6, 7.52, "bytes")),
    ((32, 64, 64, 16), True, torch.bfloat16, (10.74e9, 41.97e6, 12.53, "bytes")),
    ((32, 64, 64, 16), True, torch.float32, (10.74e9, 83.94e6, 65.08, "operations",
                                             160.3, "operations")),
    ((32, 64, 16), False, torch.float32, (1.611e9, 50.34e6, 15.03, "bytes",
                                          24.04, "operations")),
])
def test_mlp_work_bounds(widths, backward, dtype, expect):
    work = fm.mlp_work(widths, 262144, dtype, backward)
    flops, nbytes, bound_us, by = expect[:4]
    np.testing.assert_allclose([work["flops"], work["bytes"], 1e3 * work["bound_ms"]],
                               [flops, nbytes, bound_us], rtol=1e-3)
    assert work["bound_by"] == by
    if dtype == torch.float32:
        np.testing.assert_allclose(1e3 * work["bound_ms_fma"], expect[4], rtol=1e-3)
        assert work["bound_by_fma"] == expect[5]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(64,) + (257,) * 3, (16, 33, 33), (63, 30, 3)])
def test_padding_to_the_kernels_widths_is_exact(widths, dtype):
    """pad_chain (what the wrapper does on the card before a kernel):
    widths rounded up to multiples of 16 with zero rows and columns. The
    plain forward and backward of the padded chain, sliced, equal the
    unpadded chain's (f32 to 1e-6 of scale: the BLAS may block a longer
    sum differently; bf16 to one ulp), and the padding columns of y, dx and
    every dW are exactly 0."""
    x, ws = _net(widths, 3, 200)
    x = torch.from_numpy(x).to(dtype)
    ws = [torch.from_numpy(w).to(dtype) for w in ws]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((200, widths[-1]))
                         .astype(np.float32)).to(dtype)
    xp, wp, padded = fm.pad_chain(x, ws)
    assert padded == fm.padded_widths(widths) and all(d % 16 == 0 for d in padded)
    assert [tuple(w.shape) for w in wp] == list(zip(padded[:-1], padded[1:]))
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    y, yp = fm.fused_mlp_reference(x, ws), fm.fused_mlp_reference(xp, wp)
    assert (yp[:, widths[-1]:] == 0).all()
    gp = torch.nn.functional.pad(g, (0, padded[-1] - widths[-1]))
    (dx, dws), (dxp, dwsp) = (fm.fused_mlp_backward_reference(x, ws, g),
                              fm.fused_mlp_backward_reference(xp, wp, gp))
    assert (dxp[:, widths[0]:] == 0).all()
    pairs = [(y, yp[:, :widths[-1]]), (dx, dxp[:, :widths[0]])]
    for i, (a, b) in enumerate(zip(dws, dwsp)):
        assert (b[widths[i]:] == 0).all() and (b[:, widths[i + 1]:] == 0).all()
        pairs.append((a, b[:widths[i], :widths[i + 1]]))
    for a, b in pairs:
        assert (a.float() - b.float()).abs().max() <= tol * max(1.0, a.float().abs().max())


def test_padded_widths_round_up_to_16():
    """The kernels take multiples of 16, the wide ones up to 272: the
    wrapper pads OriginNeRF's 257 to 272 and a 3-wide head to 16."""
    assert fm.padded_widths([64, 257, 257, 3]) == [64, 272, 272, 16]
    assert fm.WIDE_MAX_WIDTH == 272 and fm.MAX_WIDTH == 64
