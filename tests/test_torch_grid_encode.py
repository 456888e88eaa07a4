"""Port parity for the brick3 grid encode's autograd.Function
(ops/cuda/grid_encode.py) on its CPU path, against the JAX package's
paired_encode and its VJP, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.ops import brick_grid as jbg
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.ops import brick_grid as tbg
from myc_nerfs_tpu_torch.ops.cuda import _build
from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge
from myc_nerfs_tpu_torch.utils import profiling


def launches(kernel: str) -> int:
    """The registry's launch count of ``kernel`` (utils/profiling.py)."""
    return profiling.counts(traced=False)[f"launch.{kernel}"]


torch.set_num_threads(1)

# the demo_synthetic grid: 8 levels, 2^15, finest res 256: two dense
# single-level groups and hashed groups of group_size levels
DEMO_GRID = dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0)


def _setup(group_size, n, seed, lo=0.0, hi=1.0):
    """Both packages' geometry, O(1) tables, and n positions: uniform in
    [lo, hi]^3, the first of them on cell and brick boundaries of every
    level and on the corners of the unit cube."""
    jcfg = jngp.HashGridConfig(**DEMO_GRID)
    tcfg = tngp.HashGridConfig(**DEMO_GRID)
    jl = jbg.compute_brick_levels(jcfg)
    jg = jbg.compute_level_groups(jl, group_size=group_size)
    tl = tbg.compute_brick_levels(tcfg)
    tg = tbg.compute_level_groups(tl, group_size=group_size)
    assert tl.__dict__ == jl.__dict__ and tg.groups == jg.groups
    assert {len(m) for m in tg.groups} == {1, group_size}  # dense and hashed
    rng = np.random.default_rng(seed)
    tables = [rng.uniform(-1, 1, (tl.n_bricks[m[-1]], len(m) * 2 * 128))
              .astype(np.float32) for m in tg.groups]
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    edges = [np.indices((2, 2, 2)).reshape(3, -1).T.astype(np.float32)]
    for s in tl.scales:
        k = rng.integers(0, int(np.ceil(s)) + 1, (8, 3))
        k[::2] -= k[::2] % 4  # brick boundaries
        edges.append(np.clip((k.astype(np.float32) - np.float32(0.5)) / np.float32(s),
                             0.0, 1.0))
    edges = np.concatenate(edges)[:n]
    pos[:len(edges)] = edges
    return (jcfg, jl, jg), (tcfg, tl, tg), tables, pos


def _jax_vjp(geo, tables, pos, g, dtype=None):
    """JAX paired_encode and the tables' VJP at g, as f32 numpy."""
    cfg, levels, groups = geo
    out, vjp = jax.vjp(lambda ts: jbg.paired_encode(ts, jnp.asarray(pos), cfg, levels,
                                                    groups, compute_dtype=dtype),
                       [jnp.asarray(t) for t in tables])
    (grads,) = vjp(jnp.asarray(g, out.dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(a, np.float32) for a in grads])


def _torch_vjp(geo, tables, pos, g, dtype=None):
    """The port's paired_encode (the autograd.Function, CPU path) and its
    tables' gradient at g, as f32 numpy."""
    cfg, levels, groups = geo
    ts = [torch.from_numpy(t).requires_grad_() for t in tables]
    out = tbg.paired_encode(ts, torch.from_numpy(pos), cfg, levels, groups,
                            compute_dtype=dtype)
    out.backward(torch.from_numpy(g).to(out.dtype))
    for t in ts:
        assert t.grad.dtype == torch.float32
    return out.detach().float().numpy(), [t.grad.numpy() for t in ts]


def _rel_err(a, b):
    return np.abs(a - b).max() / max(1e-30, np.abs(b).max())


@pytest.mark.parametrize("group_size", [2, 3])
@pytest.mark.parametrize("n", [1, 63, 1000])
def test_forward_f32_matches_jax(group_size, n):
    """The same cells, rows and weights as JAX's 128-lane selector matmuls:
    with O(1) tables a wrong cell shows at O(1); the 8-term sums run in
    another order (1e-5 of the scale)."""
    jgeo, tgeo, tables, pos = _setup(group_size, n, seed=n)
    g = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    ref, _ = _jax_vjp(jgeo, tables, pos, g)
    out, _ = _torch_vjp(tgeo, tables, pos, g)
    assert out.shape == (n, 16)
    assert _rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("group_size", [2, 3])
@pytest.mark.parametrize("n", [1, 63, 1000])
def test_vjp_f32_matches_jax(group_size, n):
    """The tables' gradient through paired_encode_backward_reference
    against jax.vjp: the same f32 contributions w * g summed in another
    order (1e-5 of each table gradient's scale; a dense one-row group sums
    every sample's contributions)."""
    jgeo, tgeo, tables, pos = _setup(group_size, n, seed=10 + n)
    g = np.random.default_rng(2).standard_normal((n, 16)).astype(np.float32)
    _, ref = _jax_vjp(jgeo, tables, pos, g)
    _, out = _torch_vjp(tgeo, tables, pos, g)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("group_size", [2, 3])
def test_forward_bf16_matches_jax(group_size):
    """bf16 interpolation over f32 tables: weights, values and products
    round to bf16 on both sides, but JAX sums 128 bf16 lanes where the port
    sums 8 in f32, so a feature may round to the next bf16 value: two bf16
    ulps (2^-7) of the O(1) scale."""
    jgeo, tgeo, tables, pos = _setup(group_size, 1000, seed=20)
    g = np.zeros((1000, 16), np.float32)
    ref, _ = _jax_vjp(jgeo, tables, pos, g, jnp.bfloat16)
    out, _ = _torch_vjp(tgeo, tables, pos, g, torch.bfloat16)
    assert np.abs(out - ref).max() <= 2.0 ** -7 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("group_size", [2, 3])
def test_backward_bf16_accumulates_in_f32(group_size):
    """The port's bf16 table gradient: each contribution w * g rounded to
    bf16, added in f32. The explicit backward equals the autograd of the
    plain forward to 1e-5 of the scale (the same contributions in another
    order) and stays within 1% of the f32-compute gradient on every group
    (measured 0.3-0.4%). JAX's bf16 VJP scatter-adds in bf16 and drifts
    further on the hashed groups (ROADMAP section 3), so it is not the
    reference here."""
    _, tgeo, tables, pos = _setup(group_size, 1000, seed=30)
    cfg, levels, groups = tgeo
    g = np.random.default_rng(3).standard_normal((1000, 16)).astype(np.float32)
    _, explicit = _torch_vjp(tgeo, tables, pos, g, torch.bfloat16)
    _, f32 = _torch_vjp(tgeo, tables, pos, g)
    ts = [torch.from_numpy(t).requires_grad_() for t in tables]
    out = tbg.paired_encode_reference(ts, torch.from_numpy(pos), cfg, levels, groups,
                                      compute_dtype=torch.bfloat16)
    out.backward(torch.from_numpy(g).bfloat16())
    for a, b, c in zip(explicit, [t.grad.numpy() for t in ts], f32):
        assert _rel_err(a, b) <= 1e-5
        assert _rel_err(a, c) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group_size", [2, 3])
def test_backward_reference_equals_autograd_of_plain_forward(dtype, group_size):
    """paired_encode_backward_reference is the autograd of
    paired_encode_reference, term for term (1e-6 of the scale: the same
    contributions, summed by index_add_ in place of autograd's
    index_put_)."""
    _, tgeo, tables, pos = _setup(group_size, 700, seed=40, lo=-0.1, hi=1.1)
    cfg, levels, groups = tgeo
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((700, 16))
                         .astype(np.float32)).to(dtype)
    ts = [torch.from_numpy(t).requires_grad_() for t in tables]
    p = torch.from_numpy(pos)
    tbg.paired_encode_reference(ts, p, cfg, levels, groups, compute_dtype=dtype).backward(g)
    grads = tbg.paired_encode_backward_reference(ts, p, g, cfg, levels, groups,
                                                 compute_dtype=dtype)
    for a, t in zip(grads, ts):
        assert a.dtype == torch.float32 and a.shape == t.shape
        assert _rel_err(a.numpy(), t.grad.numpy()) <= 1e-6


def test_positions_outside_the_unit_cube():
    """Padded march samples may lie outside [0, 1]: dense bricks clip,
    hashed bricks hash; every index stays inside its table and the
    features are finite. Above 1 they equal JAX's (1e-5). Below 0 a hashed
    level's brick coordinate is negative: the port wraps it to uint32 as
    the reference's integer cast does, JAX's float-to-uint32 conversion
    saturates it to 0 (ROADMAP section 3), so there only finiteness and
    the backward's consistency are checked."""
    jgeo, tgeo, tables, pos = _setup(3, 1000, seed=50, lo=0.0, hi=1.1)
    pos[:16] = np.asarray([[0.0, 0.5, 1.1], [1.1, 1.1, 1.1]] * 8, np.float32)
    g = np.random.default_rng(5).standard_normal((1000, 16)).astype(np.float32)
    ref, ref_g = _jax_vjp(jgeo, tables, pos, g)
    out, out_g = _torch_vjp(tgeo, tables, pos, g)
    assert np.isfinite(out).all()
    assert _rel_err(out, ref) <= 1e-5
    for a, b in zip(out_g, ref_g):
        assert _rel_err(a, b) <= 1e-5
    below = pos - np.float32(0.2)
    out, out_g = _torch_vjp(tgeo, tables, below, g)
    assert np.isfinite(out).all() and all(np.isfinite(a).all() for a in out_g)


def test_gradcheck_f64():
    """The CPU path's backward (paired_encode_backward_reference) is the
    derivative of its forward, by finite differences in f64 (gradcheck's
    fast mode: random directions, as the tables have ~10^5 entries)."""
    _, tgeo, tables, pos = _setup(3, 20, seed=60)
    cfg, levels, groups = tgeo
    ts = [torch.from_numpy(t).double().requires_grad_() for t in tables]
    p = torch.from_numpy(pos).double()
    assert torch.autograd.gradcheck(
        lambda *t: tbg.paired_encode(list(t), p, cfg, levels, groups), ts,
        eps=1e-6, atol=1e-8, fast_mode=True)


def test_cpu_path_counts_no_launches_and_passes_no_position_gradient():
    _, tgeo, tables, pos = _setup(3, 50, seed=70)
    before = launches("brick_encode"), launches("brick_encode_bwd")
    ts = [torch.from_numpy(t).requires_grad_() for t in tables]
    p = torch.from_numpy(pos).requires_grad_()
    tbg.paired_encode(ts, p, *tgeo).sum().backward()
    assert (launches("brick_encode"), launches("brick_encode_bwd")) == before
    assert p.grad is None and all(t.grad is not None for t in ts)


def test_model_encode_kernel_switch():
    """NGPModel.use_encode_kernel=False runs the plain torch-op encode under
    autograd; on the CPU both settings give the same outputs and the same
    gradients (1e-6 of the scale)."""
    cfg = tngp.NGPModelConfig(grid=tngp.HashGridConfig(**DEMO_GRID))
    model = tngp.NGPModel(cfg, generator=torch.Generator().manual_seed(0))
    assert model.use_encode_kernel
    rng = np.random.default_rng(6)
    pos = torch.from_numpy(rng.uniform(0, 1, (300, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.uniform(0, 1, (300, 3)).astype(np.float32))
    res = []
    for flag in (True, False):
        model.use_encode_kernel = flag
        model.zero_grad()
        out = model(pos, dirs)
        (out ** 2).sum().backward()
        res.append([out.detach()] + [p.grad.clone() for p in model.tables])
    for a, b in zip(*res):
        assert _rel_err(a.numpy(), b.numpy()) <= 1e-6


def test_failed_build_raises(tmp_path):
    """A source that does not build raises (with nvcc's output on a machine
    that has nvcc; here, that nvcc is missing): nothing is skipped."""
    broken = tmp_path / "broken.cu"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(broken)


def test_encode_work_counts_what_the_positions_touch():
    """encode_work's bytes: the forward reads only the table elements the
    positions touch (at most 8 vertices x F per sample and level, and no
    more than the tables hold, counted by the plain version's taps), the
    backward writes every element of the f32 gradients."""
    _, (cfg, levels, groups), tables, pos = _setup(3, 700, 5)
    tables = [torch.from_numpy(t) for t in tables]
    pos = torch.from_numpy(pos)
    n, L, F = 700, levels.n_levels, cfg.n_features
    fwd = ge.encode_work(tables, pos, cfg, levels, groups)
    io = n * 3 * 4 + n * L * F * 4
    touched = (fwd["bytes"] - io) // 4
    assert 0 < touched <= min(n * L * 8 * F, sum(t.numel() for t in tables))
    one = ge.encode_work(tables, pos[:1], cfg, levels, groups)
    assert (one["bytes"] - 12 - L * F * 4) // 4 == L * 8 * F  # distinct corners
    bwd = ge.encode_work(tables, pos, cfg, levels, groups, torch.bfloat16, backward=True)
    assert bwd["bytes"] == n * 3 * 4 + n * L * F * 2 + 4 * sum(t.numel() for t in tables)
    assert fwd["flops"] == bwd["flops"] == n * L * 8 * (2 * F + 2)
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_sums_the_corners_in_order(dtype):
    """paired_encode_reference sums each level's 8 rounded products in
    corner order in f32, as the kernels do, so that the two agree bit for
    bit: with table values over 40 binades the f32 sums round, and a
    pairwise order gives other sums."""
    _, (cfg, levels, groups), tables, pos = _setup(2, 1000, seed=5)
    rng = np.random.default_rng(6)
    tables = [(t * np.exp2(rng.uniform(-40, 0, t.shape))).astype(np.float32) for t in tables]
    ts = [torch.from_numpy(t) for t in tables]
    out = tbg.paired_encode_reference(ts, torch.from_numpy(pos), cfg, levels, groups,
                                      compute_dtype=dtype)
    F, reordered = cfg.n_features, 0
    for g, lv, base, w in tbg._level_taps(torch.from_numpy(pos), cfg, levels, groups, dtype):
        for f in range(F):
            p = (ts[g].reshape(-1)[base + f * 128].to(dtype) * w).float().numpy()
            seq = p[:, 0]
            for c in range(1, 8):
                seq = seq + p[:, c]
            pairs = ((p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])) + \
                    ((p[:, 4] + p[:, 5]) + (p[:, 6] + p[:, 7]))
            reordered += int((pairs != seq).sum())
            want = torch.from_numpy(seq).to(dtype)
            assert torch.equal(out[:, lv * F + f], want), (lv, f)
    assert reordered > 0
