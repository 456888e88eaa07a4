"""The port's grid-encode and gather/scatter probe kernels on a GPU, against
their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc and skips without one. This
file imports no JAX, so on a machine without it run:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_grid.py
"""
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.models import ngp
from myc_nerfs_tpu_torch.ops import brick_grid as bg
from myc_nerfs_tpu_torch.ops.cuda import _build
from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge
from myc_nerfs_tpu_torch.ops.cuda import grid_probe as gp
from myc_nerfs_tpu_torch.utils import profiling


def launches(kernel: str) -> int:
    """The registry's launch count of ``kernel`` (utils/profiling.py)."""
    return profiling.counts(traced=False)[f"launch.{kernel}"]


torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# the demo grid (dense levels, a 3-level hashed group), the Car grid (4
# dense levels, four 3-level hashed groups, 2^19), a 4-feature grid with
# 2-level groups (its levels fill no whole 32-byte chunk of the forward), a
# 5-level grid (its rows are no whole number of 16-byte vectors), and the
# Car geometry at F = 1, 4 and 8
CAR = dict(n_levels=16, log2_hashmap_size=19, aabb_scale=4)
GRIDS = {"demo": (dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0), 3),
         "car": (CAR, 3),
         "f4": (dict(n_levels=6, n_features=4, log2_hashmap_size=12,
                     desired_resolution=128.0), 2),
         "l5": (dict(n_levels=5, log2_hashmap_size=12, desired_resolution=64.0), 2),
         "car_f1": (dict(CAR, n_features=1), 3),
         "car_f4": (dict(CAR, n_features=4), 3),
         "car_f8": (dict(CAR, n_features=8), 3)}
# sample orders: uniform random (with cell and brick boundaries first); rays
# of 64 samples along a line, the march's order, so that neighbouring lanes
# share cells; the same with the first ray's 64 samples on one point; the
# same with the first 128 samples (a whole tile) on one point
LAYOUTS = ("uniform", "rays", "ray_on_point", "tile_on_point")
N_SAMPLES = [1, 63, 1000, 70001]  # 70001: a ragged last tile


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _positions(levels, n, rng, layout):
    if layout == "uniform":
        pos = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
        edges = [np.indices((2, 2, 2)).reshape(3, -1).T.astype(np.float32)]
        for s in levels.scales:
            k = rng.integers(0, int(np.ceil(s)) + 2, (64, 3))
            k[::2] -= k[::2] % 4
            edges.append((k.astype(np.float32) - np.float32(0.5)) / np.float32(s))
        edges = np.concatenate(edges)[:n]
        pos[:len(edges)] = edges
        return pos
    rays = -(-n // 64)
    origin = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.standard_normal((rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.35, (rays, 64, 1)), axis=1)
    pos = (origin + t * d).reshape(-1, 3)[:n].astype(np.float32)
    if layout == "ray_on_point":
        pos[:64] = pos[0]
    elif layout == "tile_on_point":
        pos[:128] = pos[0]
    return pos


def _setup(grid, n, device, seed=0, layout="uniform"):
    """Geometry, uniform +-1 tables and n positions in the given layout."""
    kw, group_size = GRIDS[grid]
    cfg = ngp.HashGridConfig(**kw)
    levels = bg.compute_brick_levels(cfg)
    groups = bg.compute_level_groups(levels, group_size=group_size)
    gen = torch.Generator(device).manual_seed(seed)
    tables = [torch.rand((levels.n_bricks[m[-1]], len(m) * cfg.n_features * 128),
                         device=device, generator=gen) * 2 - 1 for m in groups.groups]
    pos = _positions(levels, n, np.random.default_rng(seed), layout)
    return cfg, levels, groups, tables, torch.from_numpy(pos).to(device)


def _assert_table_grads(grads, refs, tables):
    """Kernel against plain table gradients: the same NaNs, and elsewhere
    BWD_TOL of each finite reference's scale."""
    for a, b, t in zip(grads, refs, tables):
        assert a.dtype == torch.float32 and a.shape == t.shape
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(b)
        scale = b[fin].abs().max().item() if fin.any() else 0.0
        assert (a[fin] - b[fin]).abs().max().item() <= ge.BWD_TOL * scale


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n", N_SAMPLES)
def test_brick_encode_matches_plain(cuda_device, grid, dtype, n, layout):
    cfg, levels, groups, tables, pos = _setup(grid, n, cuda_device, layout=layout)
    before = launches("brick_encode")
    with torch.no_grad():
        out = ge.brick_encode(tables, pos, cfg, levels, groups, dtype)
        ref = bg.paired_encode_reference(tables, pos, cfg, levels, groups, dtype)
    torch.cuda.synchronize()
    assert launches("brick_encode") == before + 1
    assert out.dtype == dtype and out.shape == (n, cfg.out_dim)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= ge.FWD_TOL[dtype] * scale


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n", N_SAMPLES)
def test_brick_encode_backward_matches_plain(cuda_device, grid, dtype, n, layout):
    """Zero gradients skip their contributions, also where they share a cell
    (a warp's match group) with lanes that add: whole rows, and the first
    level alone on others."""
    cfg, levels, groups, tables, pos = _setup(grid, n, cuda_device, seed=1, layout=layout)
    g = torch.randn((n, cfg.out_dim), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2)).to(dtype)
    g[::7] = 0.0
    g[2::5, :cfg.n_features] = 0.0
    before = launches("brick_encode_bwd")
    grads = ge.brick_encode_backward(tables, pos, g, cfg, levels, groups, dtype)
    refs = bg.paired_encode_backward_reference(tables, pos, g, cfg, levels, groups, dtype)
    torch.cuda.synchronize()
    assert launches("brick_encode_bwd") == before + 1
    _assert_table_grads(grads, refs, tables)


@pytest.mark.parametrize("layout", ["uniform", "tile_on_point"])
@pytest.mark.parametrize("grid", ["demo", "car"])
def test_brick_encode_backward_passes_non_finite_gradients(cuda_device, grid, layout):
    """Only an exact 0 is skipped: a NaN output gradient reaches the table
    (the trainer's skip_nonfinite must see it), also from inside a group of
    lanes on one cell whose other gradients are finite or zero."""
    n = 300
    cfg, levels, groups, tables, pos = _setup(grid, n, cuda_device, layout=layout)
    g = torch.randn((n, cfg.out_dim), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    g[:, cfg.n_features:] = 0.0   # only the first level (group 0) adds
    g[::4] = 0.0
    g[5, 0] = float("nan")
    grads = ge.brick_encode_backward(tables, pos, g, cfg, levels, groups)
    refs = bg.paired_encode_backward_reference(tables, pos, g, cfg, levels, groups)
    assert torch.isnan(grads[0]).any()
    assert all(torch.isfinite(t).all() for t in grads[1:])
    _assert_table_grads(grads, refs, tables)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paired_encode_autograd_on_gpu(cuda_device, dtype):
    """paired_encode under autograd on the card launches both kernels and
    gives the CPU plain path's table gradients (1e-5 of each one's scale:
    the same contributions added in another order); no gradient reaches
    the positions."""
    cfg, levels, groups, tables, pos = _setup("demo", 5000, cuda_device, seed=3)
    g = torch.randn((5000, cfg.out_dim), generator=torch.Generator().manual_seed(4))
    grads = {}
    for dev in ("cuda", "cpu"):
        ts = [t.detach().to(dev).requires_grad_() for t in tables]
        p = pos.detach().to(dev).requires_grad_()
        f0, b0 = launches("brick_encode"), launches("brick_encode_bwd")
        out = bg.paired_encode(ts, p, cfg, levels, groups, compute_dtype=dtype)
        (out.float() * g.to(dev)).sum().backward()
        launched = (launches("brick_encode") - f0, launches("brick_encode_bwd") - b0)
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
        assert p.grad is None
        grads[dev] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max().item() <= ge.BWD_TOL * b.abs().max().item()


def test_brick_encode_refuses_what_the_kernel_does_not_take(cuda_device):
    cfg, levels, groups, tables, pos = _setup("demo", 100, cuda_device)
    with pytest.raises(TypeError, match="float32 tables"):
        ge.brick_encode([t.double() for t in tables], pos, cfg, levels, groups)
    with pytest.raises(ValueError, match="contiguous positions"):
        ge.brick_encode(tables, pos.T.contiguous().T, cfg, levels, groups)
    with pytest.raises(ValueError, match="a table on cpu"):
        ge.brick_encode([tables[0].cpu()] + tables[1:], pos, cfg, levels, groups)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ge.brick_encode(tables, pos, cfg, levels, groups, torch.float16)
    with pytest.raises(TypeError, match="float32 positions"):
        ge.brick_encode(tables, pos.double(), cfg, levels, groups)


def test_broken_build_raises_and_is_not_replaced(cuda_device, tmp_path, monkeypatch):
    """A source nvcc refuses makes paired_encode on CUDA tensors raise with
    nvcc's output; nothing falls back to the plain version."""
    cfg, levels, groups, tables, pos = _setup("demo", 10, cuda_device)
    broken = tmp_path / "grid_encode.cu"
    broken.write_text("this is not C++\n")
    with monkeypatch.context() as m:
        m.setattr(ge, "LIB", _build.Library(broken, ge.LIB.entries))
        before = launches("brick_encode")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            bg.paired_encode(tables, pos, cfg, levels, groups)
        assert launches("brick_encode") == before
    bg.paired_encode(tables, pos, cfg, levels, groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_gather_rows_matches_plain(cuda_device, dtype, n):
    g = torch.Generator(cuda_device).manual_seed(0)
    tab = torch.randn((4096, 256), device=cuda_device, generator=g).to(dtype)
    idx = torch.randint(0, 4096, (n,), device=cuda_device, generator=g, dtype=torch.int32)
    before = launches("gather_rows")
    out = gp.gather_rows(tab, idx)
    assert launches("gather_rows") == before + 1
    assert torch.equal(out, gp.gather_rows_reference(tab, idx))


@pytest.mark.parametrize("shape", [(8, 128), (2048, 128), (5, 7)])
def test_gather_lanes_matches_plain(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(1)
    tab = torch.randn(shape, device=cuda_device, generator=g)
    idx = torch.randint(0, shape[1], (shape[0], 2 * shape[1]), device=cuda_device,
                        generator=g, dtype=torch.int32)
    before = launches("gather_lanes")
    out = gp.gather_lanes(tab, idx)
    assert launches("gather_lanes") == before + 1
    assert torch.equal(out, gp.gather_lanes_reference(tab, idx))


@pytest.mark.parametrize("n", [1, 1000, 1 << 17])
def test_scatter_add_rows_matches_plain(cuda_device, n):
    """f32 atomics add in no fixed order: 1e-5 of the scale."""
    g = torch.Generator(cuda_device).manual_seed(2)
    idx = torch.randint(0, 4096, (n,), device=cuda_device, generator=g, dtype=torch.int32)
    val = torch.randn((n, 256), device=cuda_device, generator=g)
    before = launches("scatter_add_rows")
    out = gp.scatter_add_rows(idx, val, 4096)
    assert launches("scatter_add_rows") == before + 1
    ref = gp.scatter_add_rows_reference(idx, val, 4096)
    assert (out - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("kb", [1, 16, 100, 227])
def test_smem_scratch(cuda_device, kb):
    before = launches("smem_scratch")
    out = gp.smem_scratch(kb * 1024, cuda_device)
    assert launches("smem_scratch") == before + 1
    assert torch.equal(out.cpu(), gp.smem_scratch_reference(kb * 1024, "cpu"))


def test_probe_kernels_refuse_what_they_do_not_take(cuda_device):
    """228 KB is more shared memory than a Hopper block may have: the
    refusal raises (and leaves no error behind for the next launch)."""
    before = launches("smem_scratch")
    with pytest.raises(RuntimeError, match="smem_scratch kernel launch failed"):
        gp.smem_scratch(228 * 1024, cuda_device)
    assert launches("smem_scratch") == before
    assert gp.smem_scratch(16 * 1024, cuda_device).item() == 2.0
    tab = torch.randn((64, 256), device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        gp.gather_rows(tab, torch.zeros(3, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="16 bytes"):
        gp.gather_rows(tab[:, :3].contiguous(), torch.zeros(3, dtype=torch.int32,
                                                            device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 4"):
        gp.scatter_add_rows(torch.zeros(3, dtype=torch.int32, device=cuda_device),
                            torch.zeros((3, 6), device=cuda_device), 8)
    with pytest.raises(ValueError, match="contiguous"):
        gp.gather_lanes(tab.T, torch.zeros((256, 2), dtype=torch.int32,
                                           device=cuda_device))
