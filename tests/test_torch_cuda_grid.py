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
from myc_nerfs_tpu_torch.ops.cuda import grid_encode as ge
from myc_nerfs_tpu_torch.ops.cuda import grid_probe as gp

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# the demo grid (dense levels, a 3-level hashed group), the Car grid (4
# dense levels, four 3-level hashed groups, 2^19) and a 4-feature grid with
# 2-level groups
GRIDS = {"demo": (dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0), 3),
         "car": (dict(n_levels=16, log2_hashmap_size=19, aabb_scale=4), 3),
         "f4": (dict(n_levels=6, n_features=4, log2_hashmap_size=12,
                     desired_resolution=128.0), 2)}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _setup(grid, n, device, seed=0):
    """Geometry, uniform +-1 tables and positions: uniform in [-0.1, 1.1]^3,
    the first of them on cell and brick boundaries of every level and on
    the corners of the unit cube."""
    kw, group_size = GRIDS[grid]
    cfg = ngp.HashGridConfig(**kw)
    levels = bg.compute_brick_levels(cfg)
    groups = bg.compute_level_groups(levels, group_size=group_size)
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.uniform(-1, 1, (levels.n_bricks[m[-1]],
                                                   len(m) * cfg.n_features * 128))
                               .astype(np.float32)).to(device) for m in groups.groups]
    pos = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    edges = [np.indices((2, 2, 2)).reshape(3, -1).T.astype(np.float32)]
    for s in levels.scales:
        k = rng.integers(0, int(np.ceil(s)) + 2, (64, 3))
        k[::2] -= k[::2] % 4
        edges.append((k.astype(np.float32) - np.float32(0.5)) / np.float32(s))
    edges = np.concatenate(edges)[:n]
    pos[:len(edges)] = edges
    return cfg, levels, groups, tables, torch.from_numpy(pos).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n", [1, 63, 1000, 70001])
def test_brick_encode_matches_plain(cuda_device, grid, dtype, n):
    cfg, levels, groups, tables, pos = _setup(grid, n, cuda_device)
    before = ge.brick_encode.launches
    with torch.no_grad():
        out = ge.brick_encode(tables, pos, cfg, levels, groups, dtype)
        ref = bg.paired_encode_reference(tables, pos, cfg, levels, groups, dtype)
    torch.cuda.synchronize()
    assert ge.brick_encode.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, cfg.out_dim)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= ge.FWD_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n", [1, 63, 1000, 70001])
def test_brick_encode_backward_matches_plain(cuda_device, grid, dtype, n):
    cfg, levels, groups, tables, pos = _setup(grid, n, cuda_device, seed=1)
    g = torch.randn((n, cfg.out_dim), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2)).to(dtype)
    g[::7] = 0.0  # skipped contributions
    before = ge.brick_encode_backward.launches
    grads = ge.brick_encode_backward(tables, pos, g, cfg, levels, groups, dtype)
    refs = bg.paired_encode_backward_reference(tables, pos, g, cfg, levels, groups, dtype)
    torch.cuda.synchronize()
    assert ge.brick_encode_backward.launches == before + 1
    for a, b, t in zip(grads, refs, tables):
        assert a.dtype == torch.float32 and a.shape == t.shape
        assert (a - b).abs().max().item() <= ge.BWD_TOL * b.abs().max().item()


def test_brick_encode_backward_passes_non_finite_gradients(cuda_device):
    """Only an exact 0 is skipped: a NaN output gradient reaches the table
    (the trainer's skip_nonfinite must see it)."""
    cfg, levels, groups, tables, pos = _setup("demo", 10, cuda_device)
    g = torch.zeros((10, cfg.out_dim), device=cuda_device)
    g[3, 0] = float("nan")
    grads = ge.brick_encode_backward(tables, pos, g, cfg, levels, groups)
    assert torch.isnan(grads[0]).any()
    assert all(torch.isfinite(t).all() for t in grads[1:])


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
        f0, b0 = ge.brick_encode.launches, ge.brick_encode_backward.launches
        out = bg.paired_encode(ts, p, cfg, levels, groups, compute_dtype=dtype)
        (out.float() * g.to(dev)).sum().backward()
        launched = (ge.brick_encode.launches - f0, ge.brick_encode_backward.launches - b0)
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


def test_broken_build_raises_and_is_not_replaced(cuda_device, tmp_path):
    """A source nvcc refuses makes paired_encode on CUDA tensors raise with
    nvcc's output; nothing falls back to the plain version."""
    cfg, levels, groups, tables, pos = _setup("demo", 10, cuda_device)
    broken = tmp_path / "grid_encode.cu"
    broken.write_text("this is not C++\n")
    source = ge.SOURCE
    ge._library.cache_clear()
    ge.SOURCE = broken
    try:
        before = ge.brick_encode.launches
        with pytest.raises(RuntimeError, match="nvcc failed"):
            bg.paired_encode(tables, pos, cfg, levels, groups)
        assert ge.brick_encode.launches == before
    finally:
        ge.SOURCE = source
        ge._library.cache_clear()
    bg.paired_encode(tables, pos, cfg, levels, groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_gather_rows_matches_plain(cuda_device, dtype, n):
    g = torch.Generator(cuda_device).manual_seed(0)
    tab = torch.randn((4096, 256), device=cuda_device, generator=g).to(dtype)
    idx = torch.randint(0, 4096, (n,), device=cuda_device, generator=g, dtype=torch.int32)
    before = gp.gather_rows.launches
    out = gp.gather_rows(tab, idx)
    assert gp.gather_rows.launches == before + 1
    assert torch.equal(out, gp.gather_rows_reference(tab, idx))


@pytest.mark.parametrize("shape", [(8, 128), (2048, 128), (5, 7)])
def test_gather_lanes_matches_plain(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(1)
    tab = torch.randn(shape, device=cuda_device, generator=g)
    idx = torch.randint(0, shape[1], (shape[0], 2 * shape[1]), device=cuda_device,
                        generator=g, dtype=torch.int32)
    before = gp.gather_lanes.launches
    out = gp.gather_lanes(tab, idx)
    assert gp.gather_lanes.launches == before + 1
    assert torch.equal(out, gp.gather_lanes_reference(tab, idx))


@pytest.mark.parametrize("n", [1, 1000, 1 << 17])
def test_scatter_add_rows_matches_plain(cuda_device, n):
    """f32 atomics add in no fixed order: 1e-5 of the scale."""
    g = torch.Generator(cuda_device).manual_seed(2)
    idx = torch.randint(0, 4096, (n,), device=cuda_device, generator=g, dtype=torch.int32)
    val = torch.randn((n, 256), device=cuda_device, generator=g)
    before = gp.scatter_add_rows.launches
    out = gp.scatter_add_rows(idx, val, 4096)
    assert gp.scatter_add_rows.launches == before + 1
    ref = gp.scatter_add_rows_reference(idx, val, 4096)
    assert (out - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("kb", [1, 16, 100, 227])
def test_smem_scratch(cuda_device, kb):
    before = gp.smem_scratch.launches
    out = gp.smem_scratch(kb * 1024, cuda_device)
    assert gp.smem_scratch.launches == before + 1
    assert torch.equal(out.cpu(), gp.smem_scratch_reference(kb * 1024, "cpu"))


def test_probe_kernels_refuse_what_they_do_not_take(cuda_device):
    """228 KB is more shared memory than a Hopper block may have: the
    refusal raises (and leaves no error behind for the next launch)."""
    before = gp.smem_scratch.launches
    with pytest.raises(RuntimeError, match="smem_scratch kernel launch failed"):
        gp.smem_scratch(228 * 1024, cuda_device)
    assert gp.smem_scratch.launches == before
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
