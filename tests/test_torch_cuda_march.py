"""The fused NGP march kernel (csrc/march.cu) and its backward on a GPU,
against its plain PyTorch version, render/ngp_render.py::
march_rays_fused_plain, on CUDA tensors.

Every test here needs an NVIDIA GPU and nvcc and skips without one. This
file imports no JAX, so on a machine without it run:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_march.py

Exactness: every output of the kernel equals the plain version's bit for
bit, on every ray, except where the two sum the coarse optical depth in
different orders (the kernel: each lane's bins left to right, then a
Hillis-Steele scan over the lanes' sums; torch: its CUDA cumsum's tree). A
ray may then keep or drop a bin on one side only where its logT_prev lies
within that sum's rounding of log(eps) at an occupied bin:
``truncation_margin`` at most NEAR, the forward error bound of two
summation orders of n_coarse non-negative terms that sum to |log(eps)|
(each within (n_coarse - 1) * 2^-24 of the sum). Such rays are counted,
and at most MAX_DIFFERING_SHARE of the rays (and at least one) may differ.
Without truncation (trunc_eps 0) no ray may differ.

The backward kernel sums in another order than autograd does over the
plain version, so its gradients equal the plain version's to GRAD_RTOL,
beside GRAD_ATOL of a scale, on every ray whose forward outputs are equal.
The scale of rays_o's and rays_d's gradients is the ray's largest
component: a ray that misses the box along a zero direction component has
a gradient of ~1e10 to its origin, through 1 / 1e-10, which would hide
every other ray's. xi's gradient is the sum of t's gradients over the
samples times dt, a sum that can cancel to a small fraction of its terms,
and no such path reaches it: its scale is its largest over the rays.
"""
import math

import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import march as march_cuda
from myc_nerfs_tpu_torch.render import ngp_render as nr
from myc_nerfs_tpu_torch.render import occupancy as occ
from myc_nerfs_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

MAX_DIFFERING_SHARE = 1e-3
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-4


def near_bound(n_coarse: int, eps: float) -> float:
    """NEAR: two summation orders of n_coarse non-negative terms with a sum
    of |log eps| differ by at most 2 (n_coarse - 1) 2^-24 |log eps|."""
    return 2 * (n_coarse - 1) * 2.0 ** -24 * abs(float(np.log(np.float32(eps))))


def truncation_margin(occ_cfg, rcfg, occ_state, rays_o, rays_d, trunc_eps=None):
    """[N]: how close each ray's coarse log transmittance comes to log(eps)
    at an occupied bin, |logT_prev - log(eps)| at its closest (inf with no
    occupied bin or no truncation), by march_rays_fused_plain's arithmetic.
    The kernel sums logT_prev in another order (csrc/march.cu), so its live
    bins can differ from the plain version's only on a ray whose margin lies
    within that sum's rounding."""
    eps = rcfg.early_stop_eps if trunc_eps is None else trunc_eps
    _, _, _, _, occ_c, logT_prev = nr._coarse_pass(occ_cfg, rcfg, occ_state, rays_o, rays_d)
    if not eps > 0:
        return torch.full(occ_c.shape[:1], float("inf"), device=occ_c.device)
    gap = (logT_prev - float(np.log(np.float32(eps)))).abs()
    return torch.where(occ_c, gap, float("inf")).amin(1)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def launches() -> int:
    return profiling.counts(traced=False)["launch.march_rays_fused"]


def grid_state(cfg: occ.OccupancyConfig, seed: int, device) -> occ.OccupancyState:
    """Empty, untrained (-1) and dense cells at random, with the bitfield
    and mean that update_bitfield derives from them."""
    g = torch.Generator().manual_seed(seed)
    G, C = cfg.grid_size, cfg.n_cascades
    u = torch.rand((C, G, G, G), generator=g)
    grid = torch.where(u > 0.55, 0.08 * u, 0.0)
    grid[torch.rand(grid.shape, generator=g) < 0.05] = -1.0
    bits, mean = occ.update_bitfield(cfg, grid)
    return occ.OccupancyState(density_grid=grid.to(device), bitfield=bits.to(device),
                              mean_density=mean.to(device),
                              ema_step=torch.zeros((), dtype=torch.int32, device=device))


def rays(n: int, aabb_scale: float, seed: int, device):
    """Origins outside the AABB aimed at points inside it; every 8th ray
    aimed away (it misses: span 0), every 8th starting inside the box, and
    every 64th with a zero direction component."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = 0.5 - aabb_scale / 2, 0.5 + aabb_scale / 2
    o = torch.randn((n, 3), generator=g)
    o = 0.5 + o / o.norm(dim=-1, keepdim=True) * aabb_scale * 1.2
    target = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    o[1::8] = target[1::8] * 0.5 + 0.25
    d = target - o
    d[::8] = -d[::8]
    d[2::64, 0] = 0.0
    d = d / d.norm(dim=-1, keepdim=True)
    return o.to(device), d.to(device)


def bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def compare(cfg, rcfg, state, o, d, xi, K, eps):
    """Kernel against plain: (rays differing in any bit of any output,
    rays within NEAR of log eps, the kernel's MarchedRays)."""
    with torch.no_grad():
        got = nr.march_rays_fused(cfg, rcfg, state, o, d, xi, n_samples=K, trunc_eps=eps)
        want = nr.march_rays_fused_plain(cfg, rcfg, state, o, d, xi, n_samples=K,
                                         trunc_eps=eps)
        N = o.shape[0]
        same = torch.ones(N, dtype=torch.bool, device=o.device)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            same &= (bits(a) == bits(b)).reshape(N, -1).all(1)
        margin = truncation_margin(cfg, rcfg, state, o, d, eps)
        near = margin <= (near_bound(rcfg.n_coarse, eps) if eps > 0 else -1.0)
    return ~same, near, got


def check(differing, near, n: int) -> None:
    assert not (differing & ~near).any(), (
        f"{int((differing & ~near).sum())} rays differ away from the truncation boundary")
    assert int(differing.sum()) <= max(1, math.floor(MAX_DIFFERING_SHARE * n))


@pytest.mark.parametrize("aabb_scale", [1, 4])
@pytest.mark.parametrize("const_dt", [True, False])
@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_kernel_equals_plain(cuda, aabb_scale, const_dt, jitter, K, eps):
    """Each variant the fused march serves, at 1001 rays (not a multiple of
    the kernel's 8 rays per CTA), with rays that miss the box."""
    cfg = occ.OccupancyConfig(grid_size=32, n_cascades=3,
                              max_cascade=2 if aabb_scale == 4 else 0)
    state = grid_state(cfg, 5, cuda)
    rcfg = nr.NGPRenderConfig(aabb_scale=aabb_scale, n_coarse=64, n_samples=K,
                              const_dt=const_dt, near_distance=0.05)
    o, d = rays(1001, aabb_scale, 6, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    xi = torch.rand((1001, 1), generator=g, device=cuda) if jitter else None
    differing, near, got = compare(cfg, rcfg, state, o, d, xi, K, eps)
    assert 0.02 < got.valid.float().mean().item() < 0.98
    assert not got.valid[::8].any()  # the rays aimed away
    check(differing, near, 1001)
    if eps > 0:  # the truncation decides bins here
        with torch.no_grad():
            whole = nr.march_rays_fused(cfg, rcfg, state, o, d, xi, n_samples=K,
                                        trunc_eps=0.0)
        assert (whole.valid != got.valid).any()


@pytest.mark.parametrize("n_rays, jitter", [(4096, False), (20000, True)])
def test_kernel_equals_plain_at_car_shapes(cuda, n_rays, jitter):
    """The main path's shapes: Car's cascaded grid (5 x 128^3), n_coarse
    512, 64 samples, truncation at early_stop_eps; a render chunk (xi None)
    and a training batch (xi drawn)."""
    cfg = occ.OccupancyConfig(max_cascade=2)
    state = grid_state(cfg, 11, cuda)
    rcfg = nr.NGPRenderConfig(aabb_scale=4, n_coarse=512, n_samples=64, n_compact=64)
    o, d = rays(n_rays, 4, 12, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    xi = torch.rand((n_rays, 1), generator=g, device=cuda) if jitter else None
    differing, near, got = compare(cfg, rcfg, state, o, d, xi, 64, rcfg.early_stop_eps)
    assert got.valid.any()
    check(differing, near, n_rays)


def test_kernel_equals_plain_off_powers_of_two(cuda):
    """n_coarse 96, K 20 and an AABB of extent 3: torch's divisions by those
    Python numbers (products with their f32 reciprocals on CUDA) are not
    exact here."""
    cfg = occ.OccupancyConfig(grid_size=32, n_cascades=3, max_cascade=2)
    state = grid_state(cfg, 17, cuda)
    rcfg = nr.NGPRenderConfig(aabb_scale=3, n_coarse=96, const_dt=False, near_distance=0.05)
    o, d = rays(777, 3, 18, cuda)
    xi = torch.rand((777, 1), generator=torch.Generator(device=cuda).manual_seed(19),
                    device=cuda)
    differing, near, got = compare(cfg, rcfg, state, o, d, xi, 20, 4.5e-3)
    assert got.valid.any()
    check(differing, near, 777)


def launches_bwd() -> int:
    return profiling.counts(traced=False)["launch.march_rays_fused_bwd"]


def march_loss(m: nr.MarchedRays, gen: torch.Generator) -> torch.Tensor:
    """A random linear function of every differentiable output."""
    def w(x):
        return torch.randn(x.shape, generator=gen, device=x.device)

    return ((w(m.positions) * m.positions).sum() + (w(m.dirs) * m.dirs).sum()
            + (w(m.t) * m.t).sum() + (w(m.dt) * m.dt).sum())


def grads(fn, cfg, rcfg, state, o, d, xi, K, eps, seed):
    """The march's outputs and the gradient of march_loss to rays_o, rays_d
    and xi (None without xi)."""
    leaves = [o.clone().requires_grad_(True), d.clone().requires_grad_(True)]
    if xi is not None:
        leaves.append(xi.clone().requires_grad_(True))
    out = fn(cfg, rcfg, state, *leaves[:2], leaves[2] if xi is not None else None,
             n_samples=K, trunc_eps=eps)
    gen = torch.Generator(device=o.device).manual_seed(seed)
    got = torch.autograd.grad(march_loss(out, gen), leaves)
    return out, list(got) + ([None] if xi is None else [])


def rays_off(got, want) -> dict:
    """Per gradient (rays_o, rays_d, xi) the [N] rays on which the kernel's
    is not the plain version's to GRAD_RTOL beside GRAD_ATOL of its scale
    (None where there is no xi)."""
    off = {}
    for name, a, b in zip(("rays_o", "rays_d", "xi"), got, want):
        if b is None:
            assert a is None
            off[name] = None
            continue
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        scale = b.abs().amax(1, keepdim=True) if name != "xi" else b.abs().max()
        off[name] = ~(torch.isfinite(a)
                      & ((a - b).abs() <= GRAD_ATOL * scale + GRAD_RTOL * b.abs())).all(1)
    return off


def assert_grads_close(got, want, keep) -> None:
    for (name, off), a in zip(rays_off(got, want).items(), got):
        if off is not None:
            bad = keep & off
            assert not bad.any(), f"{name}: {int(bad.sum())} rays, e.g. {a[bad][:3].tolist()}"


@pytest.mark.parametrize("aabb_scale", [1, 4])
@pytest.mark.parametrize("const_dt", [True, False])
@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_kernel_gradient_equals_plain(cuda, aabb_scale, const_dt, jitter, eps):
    """The backward kernel against autograd through the plain version: the
    gradient of a random linear function of positions, dirs, t and dt to
    rays_o, rays_d and xi, at 1001 rays with misses, starts inside the box
    and zero direction components (cone-angle dt: its clamp and its ties
    with arc / K decide where the gradient goes)."""
    cfg = occ.OccupancyConfig(grid_size=32, n_cascades=3,
                              max_cascade=2 if aabb_scale == 4 else 0)
    state = grid_state(cfg, 5, cuda)
    rcfg = nr.NGPRenderConfig(aabb_scale=aabb_scale, n_coarse=64, n_samples=16,
                              const_dt=const_dt, near_distance=0.05)
    o, d = rays(1001, aabb_scale, 6, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    xi = torch.rand((1001, 1), generator=g, device=cuda) if jitter else None
    differing, near, _ = compare(cfg, rcfg, state, o, d, xi, 16, eps)
    check(differing, near, 1001)
    profiling.reset()
    out, got = grads(nr.march_rays_fused, cfg, rcfg, state, o, d, xi, 16, eps, 8)
    assert (launches(), launches_bwd()) == (1, 1)
    _, want = grads(nr.march_rays_fused_plain, cfg, rcfg, state, o, d, xi, 16, eps, 8)
    assert got[0].abs().sum() > 0 and got[1].abs().sum() > 0
    assert_grads_close(got, want, ~differing)


def test_dispatch_counts_and_gradients(cuda):
    """march_rays_fused launches the kernel once per call on CUDA rays,
    under no_grad or not, requiring grad or not; where autograd records,
    the backward kernel carries the gradient of t and dt to the rays, as
    the plain version's own (to GRAD_RTOL), once per backward."""
    cfg = occ.OccupancyConfig(grid_size=32, n_cascades=3, max_cascade=2)
    state = grid_state(cfg, 5, cuda)
    rcfg = nr.NGPRenderConfig(aabb_scale=4, n_coarse=64, n_samples=16, near_distance=0.05)
    o, d = rays(256, 4, 6, cuda)
    profiling.reset()
    with torch.no_grad():
        for _ in range(2):
            nr.march_rays_fused(cfg, rcfg, state, o, d)
    out = nr.march_rays_fused(cfg, rcfg, state, o, d)
    assert launches() == 3 and not out.t.requires_grad
    o_req = o.clone().requires_grad_(True)
    with torch.no_grad():
        nr.march_rays_fused(cfg, rcfg, state, o_req, d)
    assert launches() == 4
    out = nr.march_rays_fused(cfg, rcfg, state, o_req, d)
    assert (launches(), launches_bwd()) == (5, 0) and out.t.requires_grad
    assert not out.valid.requires_grad
    (torch.where(out.valid, out.t, 0.0).sum() + out.dt.sum()).backward()
    assert launches_bwd() == 1
    o_plain = o.clone().requires_grad_(True)
    ref = nr.march_rays_fused_plain(cfg, rcfg, state, o_plain, d)
    (torch.where(ref.valid, ref.t, 0.0).sum() + ref.dt.sum()).backward()
    assert torch.isfinite(o_req.grad).all() and o_req.grad.abs().sum() > 0
    assert not rays_off([o_req.grad], [o_plain.grad])["rays_o"].any()


def test_wrapper_raises_and_takes_empty_batches(cuda):
    """What the kernel does not take raises (no fallback); no rays, no
    launch, with or without a gradient."""
    cfg = occ.OccupancyConfig(grid_size=32, n_cascades=3, max_cascade=2)
    state = grid_state(cfg, 5, cuda)
    rcfg = nr.NGPRenderConfig(aabb_scale=4, n_coarse=64, n_samples=16)
    o, d = rays(64, 4, 6, cuda)
    c = nr.march_constants(cfg, rcfg, 16, 1e-4)
    args = (state.density_grid, state.mean_density)
    with pytest.raises(TypeError):
        march_cuda.march_fused(c, *args, o, d, torch.rand((64, 1), dtype=torch.float64,
                                                          device=cuda))
    wide = march_cuda.MarchConstants.from_buffer_copy(c)
    wide.n_coarse = 12289  # its row of floats would pass a CTA's 48 KB
    with pytest.raises(ValueError, match="outside what the kernel takes"):
        march_cuda.march_fused(wide, *args, o, d)
    with pytest.raises(ValueError):
        march_cuda.march_fused(c, state.density_grid.cpu(), state.mean_density, o, d)
    profiling.reset()
    out = nr.march_rays_fused(cfg, rcfg, state, o[:0], d[:0])
    assert out.positions.shape == (0, 16, 3) and out.valid.shape == (0, 16)
    o_req = o[:0].clone().requires_grad_(True)
    out = nr.march_rays_fused(cfg, rcfg, state, o_req, d[:0])
    out.t.sum().backward()
    assert o_req.grad.shape == (0, 3)
    assert (launches(), launches_bwd()) == (0, 0)
