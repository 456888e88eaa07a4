"""The NGP compositor without a GPU: render/ngp_render.py::composite_marched
on CPU tensors is composite_marched_plain, the eager composition (the oracle
of csrc/composite.cu), against the JAX package's composite_weights and
composite_rgb; the kernel wrapper (ops/cuda/composite.py) imports, refuses
CPU tensors and lays out the kernels' arguments from the inputs' strides;
its autograd.Function, driven through a stand-in for the kernels' C entry
points, gives each input the gradient autograd gives through the eager
composition; its launch counters are declared. The kernels themselves:
tests/test_torch_cuda_composite.py, on the card."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.render import composite as jcomp
from myc_nerfs_tpu_torch.ops.cuda import _build
from myc_nerfs_tpu_torch.ops.cuda import composite as cc
from myc_nerfs_tpu_torch.render import ngp_render as nr
from myc_nerfs_tpu_torch.utils import profiling

torch.set_num_threads(1)

EPS = 1e-4
COUNTERS = ["launch.ngp_composite", "launch.ngp_composite_bwd"]


def case(n: int, k: int, bg: str, seed: int = 0):
    """raw [n, k, 4], MarchedRays (dt one step per ray broadcast over the
    samples, as the march gives it) and bg [3] or [n, 3]: a ray with no
    valid sample, all-valid rays, dense rays the early stop ends, raw_d
    above 30 and below -15."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((n, k, 4), generator=g) * 3
    raw[1::4, :, 3] += 6.0
    raw[2, 1, 3] = 40.0
    raw[3, :4, 3] = -20.0
    dt = (torch.rand((n, 1), generator=g) * 0.05 + 1e-3).expand(n, k)
    t = torch.cumsum(torch.rand((n, k), generator=g) * 0.05, -1) + 0.2
    valid = torch.rand((n, k), generator=g) > 0.3
    valid[::5] = True
    valid[0] = False
    colour = torch.rand((n, 3) if bg == "per_ray" else (3,), generator=g)
    return raw, nr.MarchedRays(positions=None, dirs=None, dt=dt, t=t, valid=valid), colour


@pytest.mark.parametrize("bg", ["shared", "per_ray"])
@pytest.mark.parametrize("k", [64, 20])
def test_cpu_route_is_the_eager_composition(k, bg):
    """composite_marched on CPU tensors: composite_marched_plain's outputs
    bit for bit, in their shapes and dtypes (n_samples the int64 scalar
    valid.sum()), their gradient to raw too, and no kernel launch."""
    raw, marched, colour = case(256, k, bg, seed=k)
    profiling.reset()
    r_got, r_want = raw.clone().requires_grad_(), raw.clone().requires_grad_()
    got = nr.composite_marched(r_got, marched, colour, EPS)
    want = nr.composite_marched_plain(r_want, marched, colour, EPS)
    assert {c: profiling.counts()[c] for c in COUNTERS} == dict.fromkeys(COUNTERS, 0)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
    assert got.rgb.shape == (256, 3) and got.depth.shape == (256,)
    assert got.opacity.shape == (256,) and got.rgb.dtype == torch.float32
    assert got.n_samples.dtype == torch.int64 and got.n_samples.shape == ()
    assert int(got.n_samples) == int(marched.valid.sum())
    g = torch.randn((256, 3), generator=torch.Generator().manual_seed(1))
    (g_got,) = torch.autograd.grad((got.rgb * g).sum() + got.depth.sum(), r_got)
    (g_want,) = torch.autograd.grad((want.rgb * g).sum() + want.depth.sum(), r_want)
    assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("bg", ["shared", "per_ray"])
def test_cpu_route_matches_the_jax_compositor(bg):
    """The same composition as the JAX package's: its density and rgb
    activations, composite_weights and composite_rgb, and the depth sum."""
    raw, marched, colour = case(128, 24, bg, seed=2)
    out = nr.composite_marched(raw, marched, colour, EPS)
    j_raw = jnp.asarray(raw.numpy())
    sigma = jngp.density_activation(j_raw[..., 3])
    w, t_left = jcomp.composite_weights(sigma, jnp.asarray(marched.dt.numpy()),
                                        jnp.asarray(marched.valid.numpy()), EPS)
    rgb = jcomp.composite_rgb(jngp.rgb_activation(j_raw[..., :3]), w, t_left,
                              jnp.asarray(colour.numpy()))
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(rgb), atol=1e-5)
    np.testing.assert_allclose(out.opacity.numpy(), 1.0 - np.asarray(t_left)[:, 0], atol=1e-5)
    np.testing.assert_allclose(out.depth.numpy(),
                               np.asarray((w * jnp.asarray(marched.t.numpy())).sum(-1)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", COUNTERS)
def test_launch_counters_are_declared(name):
    assert name in profiling.COUNTERS


def test_wrapper_imports_without_cuda_and_refuses_cpu_tensors():
    """The module loads no library on import, its source is one of the
    kernel sources, and CPU tensors raise before anything is built."""
    assert cc.LIB._functions is None
    assert cc.SOURCE in _build.kernel_sources()
    raw, marched, colour = case(8, 4, "shared")
    with pytest.raises(ValueError, match="unsupported device"):
        cc.ngp_composite(raw, marched.dt, marched.t, marched.valid, colour, EPS)
    assert cc.LIB._functions is None


@pytest.mark.parametrize("bg", ["shared", "per_ray"])
def test_kernel_arguments_follow_the_strides(bg):
    """The inputs reach the kernels through their strides, broadcast to
    [N, K] and bg to [N, 3]: dt one value per ray (column stride 0), t as
    it lies, a shared background (row stride 0)."""
    raw, marched, colour = case(8, 6, bg)
    args = cc._inputs(raw, marched.dt[:, :1], marched.t, marched.valid, colour, EPS)
    assert args[0] == raw.data_ptr()
    assert args[1:4] == [marched.dt.data_ptr(), 1, 0]
    assert args[4:7] == [marched.t.data_ptr(), 6, 1]
    assert args[7:10] == [marched.valid.data_ptr(), 6, 1]
    assert args[10:13] == [colour.data_ptr(), *((0, 1) if bg == "shared" else (3, 1))]
    assert args[13:] == [EPS, 8, 6]
    assert len(args) == len(cc._INPUTS)


@pytest.mark.parametrize("shape, ok", [((3,), True), ((1, 3), True), ((8, 3), True),
                                       ((8, 1), True), ((2,), False), ((4, 3), False),
                                       ((2, 8, 3), False)])
def test_broadcast_check(shape, ok):
    assert cc._broadcasts(shape, (8, 3)) == ok


def _at(ptr: int, shape, strides, ctype) -> torch.Tensor:
    """The memory at ptr as a tensor of shape and element strides."""
    n = 1 + sum((a - 1) * b for a, b in zip(shape, strides))
    arr = np.frombuffer((ctype * n).from_address(ptr), dtype=np.dtype(ctype))
    return torch.from_numpy(np.lib.stride_tricks.as_strided(
        arr, shape, [b * arr.itemsize for b in strides]))


def _kernel_stand_in(name, device, *args, counter):
    """The C entry points' arguments read back from memory, and their
    outputs written there: the forward by the eager composition, the
    backward by the kernel's own formulas (csrc/composite.cu's header)."""
    raw_p, dt_p, dt_r, dt_c, t_p, t_r, t_c, v_p, v_r, v_c, bg_p, bg_r, bg_c, eps, N, K = args[:16]
    raw = _at(raw_p, (N, K, 4), (4 * K, 4, 1), ctypes.c_float)
    dt = _at(dt_p, (N, K), (dt_r, dt_c), ctypes.c_float)
    t = _at(t_p, (N, K), (t_r, t_c), ctypes.c_float)
    valid = _at(v_p, (N, K), (v_r, v_c), ctypes.c_uint8).bool()
    bg = _at(bg_p, (N, 3), (bg_r, bg_c), ctypes.c_float)
    if name == "ngp_composite_fwd":
        out = nr.composite_marched_plain(raw, nr.MarchedRays(None, None, dt, t, valid), bg, eps)
        for ptr, x in zip(args[16:19], out[:3]):
            _at(ptr, x.shape, x.stride(), ctypes.c_float).copy_(x)
    else:
        g_rgb, g_depth, g_opacity, g_raw, g_dt, g_t = args[16:22]
        gr = _at(g_rgb, (N, 3), (3, 1), ctypes.c_float) if g_rgb else torch.zeros(N, 3)
        gd = _at(g_depth, (N,), (1,), ctypes.c_float) if g_depth else torch.zeros(N)
        go = _at(g_opacity, (N,), (1,), ctypes.c_float) if g_opacity else torch.zeros(N)
        sigma = torch.exp(raw[..., 3].clamp_max(30.0))
        c = torch.sigmoid(raw[..., :3])
        sd = torch.where(valid, sigma * dt, 0.0)
        T = torch.exp(-(torch.cumsum(sd, -1) - sd))
        e = torch.exp(-sd)
        m = valid & (T > eps)
        w = torch.where(m, T * (1 - e), 0.0)
        one_minus = 1 - w.sum(-1)
        g_w_sum = torch.where((one_minus >= 0) & (one_minus <= 1),
                              go - (gr * bg).sum(-1), 0.0)
        gw = (gr[:, None, :] * c).sum(-1) + gd[:, None] * t + g_w_sum[:, None]
        later = torch.flip(torch.cumsum(torch.flip(gw * w, [1]), 1), [1]) - gw * w
        g_sd = torch.where(m, gw * T * e, 0.0) - later
        if g_raw:
            g = torch.cat([(gr[:, None, :] * w[..., None]) * (1 - c) * c,
                           (torch.where(valid, g_sd * dt, 0.0)
                            * torch.exp(raw[..., 3].clamp(-15.0, 15.0)))[..., None]], -1)
            _at(g_raw, (N, K, 4), (4 * K, 4, 1), ctypes.c_float).copy_(g)
        if g_dt:
            _at(g_dt, (N, K), (K, 1), ctypes.c_float).copy_(torch.where(valid, g_sd * sigma, 0.0))
        if g_t:
            _at(g_t, (N, K), (K, 1), ctypes.c_float).copy_(gd[:, None] * w)
    profiling.count(counter, 1)


@pytest.mark.parametrize("wrt", ["raw", "dt", "t", "bg", "raw,dt,t,bg"])
@pytest.mark.parametrize("bg", ["shared", "per_ray"])
def test_autograd_function_gives_each_input_its_gradient(monkeypatch, wrt, bg):
    """_CompositeFn's backward asks the kernel for the gradients wanted
    (raw, dt, t: t only where depth has a cotangent), forms bg's from the
    forward's opacity and sums each to its input's shape: dt one step per
    ray, broadcast over the samples as the march gives it. Against autograd
    through the eager composition, with the kernel's entry points stood in
    for on the CPU; one forward launch, and one backward launch unless bg
    alone wants a gradient."""
    raw, marched, colour = case(96, 40, bg, seed=4)
    wanted = wrt.split(",")
    g = torch.Generator().manual_seed(5)
    cot = [torch.randn((96, 3), generator=g), torch.randn(96, generator=g),
           torch.randn(96, generator=g)]
    monkeypatch.setattr(cc.LIB, "launch", _kernel_stand_in)

    def grads(composite):
        leaves = {"raw": raw.clone(), "dt": marched.dt[:, :1].clone(), "t": marched.t.clone(),
                  "bg": colour.clone()}
        for name in wanted:
            leaves[name].requires_grad_()
        out = composite(leaves["raw"], leaves["dt"].expand(96, 40), leaves["t"], marched.valid,
                        leaves["bg"])
        loss = sum((x * y).sum() for x, y in zip(out[:3], cot))
        return out, torch.autograd.grad(loss, [leaves[n] for n in wanted])

    profiling.reset()
    got_out, got = grads(lambda r, dt, t, v, b: cc._CompositeFn.apply(r, dt, t, v, b, EPS))
    assert [profiling.counts()[c] for c in COUNTERS] == [1, int(wrt != "bg")]
    want_out, want = grads(lambda r, dt, t, v, b: nr.composite_marched_plain(
        r, nr.MarchedRays(None, None, dt, t, v), b, EPS))
    assert int(got_out[3]) == int(want_out.n_samples)
    for x, y in zip(got_out[:3], want_out[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for name, x, y in zip(wanted, got, want):
        assert x.shape == y.shape, name
        assert ((x - y).norm() / y.norm()).item() <= 1e-5, name
