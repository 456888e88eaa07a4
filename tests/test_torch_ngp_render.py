"""Port parity: occupancy grid, its update, the fused march and the NGP
render of myc_nerfs_tpu_torch against myc_nerfs_tpu, at aabb_scale 1 and 4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.render import composite as jcomp
from myc_nerfs_tpu.render import ngp_render as jnr
from myc_nerfs_tpu.render import occupancy as jocc
from myc_nerfs_tpu_torch.core.bridge import (load_ngp_params,
                                             occupancy_from_numpy,
                                             occupancy_to_numpy)
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.render import composite as tcomp
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.render import occupancy as tocc
from myc_nerfs_tpu_torch.utils import profiling

torch.set_num_threads(1)

G = 32  # a small grid: 3 cascades of 32^3 cells
DEMO_GRID = dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0)


def _occ_cfgs(max_cascade):
    kw = dict(grid_size=G, n_cascades=3, max_cascade=max_cascade)
    return jocc.OccupancyConfig(**kw), tocc.OccupancyConfig(**kw)


def _random_state(jcfg, seed):
    """A structured grid: empty, untrained (-1) and dense cells, with the
    bitfield and mean that update_bitfield derives from it."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (3, G, G, G)).astype(np.float32)
    grid = np.where(u > 0.55, 0.08 * u, 0.0).astype(np.float32)
    grid[rng.uniform(0, 1, grid.shape) < 0.05] = -1.0
    bits, mean = jocc.update_bitfield(jcfg, jnp.asarray(grid))
    return jocc.OccupancyState(density_grid=jnp.asarray(grid), bitfield=bits,
                               mean_density=mean,
                               ema_step=jnp.zeros((), jnp.int32))


def _to_port(jstate):
    return occupancy_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jstate._asdict()))


def _models(aabb_scale, seed=0):
    jcfg = jngp.NGPModelConfig(grid=jngp.HashGridConfig(aabb_scale=aabb_scale,
                                                        **DEMO_GRID))
    tcfg = tngp.NGPModelConfig(grid=tngp.HashGridConfig(aabb_scale=aabb_scale,
                                                        **DEMO_GRID))
    jm = jngp.NGPModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = {"table": [jnp.asarray(rng.uniform(-1, 1, t.shape), t.dtype)
                        for t in params["table"]], "mlp": params["mlp"]}
    tm = tngp.NGPModel(tcfg)
    load_ngp_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _rays(n, aabb_scale, seed):
    """Origins outside the AABB, aimed at random points inside it."""
    rng = np.random.default_rng(seed)
    lo, hi = 0.5 - aabb_scale / 2, 0.5 + aabb_scale / 2
    o = rng.standard_normal((n, 3))
    o = 0.5 + o / np.linalg.norm(o, axis=-1, keepdims=True) * aabb_scale * 1.2
    d = rng.uniform(lo, hi, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("max_cascade", [0, 2])
def test_lookups_and_mip(max_cascade):
    """Cascade selection and the one-gather lookups read the same cells
    (exact: integer index math on identical floats)."""
    jcfg, tcfg = _occ_cfgs(max_cascade)
    js = _random_state(jcfg, 1)
    ts = _to_port(js)
    pos = np.random.default_rng(2).uniform(-1.5, 2.5, (2000, 3)).astype(np.float32)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    jmip = jocc.mip_from_pos(jcfg, jp)
    tmip = tocc.mip_from_pos(tcfg, tp)
    np.testing.assert_array_equal(tmip.numpy(), np.asarray(jmip))
    np.testing.assert_array_equal(
        tocc.occupied_at(tcfg, ts.bitfield, tp, tmip).numpy(),
        np.asarray(jocc.occupied_at(jcfg, js.bitfield, jp, jmip)))
    np.testing.assert_array_equal(
        tocc.sigma_at(tcfg, ts.density_grid, tp, tmip).numpy(),
        np.asarray(jocc.sigma_at(jcfg, js.density_grid, jp, jmip)))
    inside = np.clip(pos, 0.0, 1.0)
    np.testing.assert_array_equal(
        tocc.occupied_at_mip0(tcfg, ts.bitfield, torch.from_numpy(inside)).numpy(),
        np.asarray(jocc.occupied_at_mip0(jcfg, js.bitfield, jnp.asarray(inside))))


def test_update_bitfield_and_cell_centers():
    jcfg, tcfg = _occ_cfgs(2)
    js = _random_state(jcfg, 3)
    bits, mean = tocc.update_bitfield(tcfg, torch.tensor(
        np.asarray(js.density_grid)))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(js.bitfield))
    np.testing.assert_allclose(mean.item(), float(js.mean_density), rtol=1e-6)
    for lv in range(3):
        np.testing.assert_array_equal(tocc.cell_centers(tcfg, lv).numpy(),
                                      np.asarray(jocc.cell_centers(jcfg, lv)))


def _jax_draws(jcfg, key, n):
    """The draws jocc.generate_grid_samples makes from ``key``."""
    k_level, k_probe, k_jitter = jax.random.split(key, 3)
    return tocc.GridDraws(
        level=torch.from_numpy(np.asarray(jax.random.randint(
            k_level, (n,), 0, jcfg.max_cascade + 1)).astype(np.int64)),
        base=torch.from_numpy(np.asarray(jax.random.randint(
            k_probe, (n,), 0, G ** 3, dtype=jnp.int32)).astype(np.int64)),
        jitter=torch.from_numpy(np.array(jax.random.uniform(k_jitter, (n, 3)))))


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_density_grid_update_fed_jax_draws(aabb_scale):
    """One make_density_grid_update step given JAX's own random draws: the
    same cells, the same splatted densities (rtol 1e-5: the field differs
    by f32 summation order), the same bitfield."""
    jcfg, tcfg = _occ_cfgs(2 if aabb_scale == 4 else 0)
    jm, params, tm = _models(aabb_scale)
    lo, hi = 0.5 - aabb_scale / 2, 0.5 + aabb_scale / 2
    js = _random_state(jcfg, 4)
    n = 2048
    jupd = jocc.make_density_grid_update(jcfg, jm.density_raw, n, n, (lo, hi))
    tupd = tocc.make_density_grid_update(tcfg, tm.density_raw, n, n, (lo, hi))
    key = jax.random.PRNGKey(7)
    k_u, k_n = jax.random.split(key)
    ref = jupd(js, params, key)
    out = tupd(_to_port(js), draws=(_jax_draws(jcfg, k_u, n),
                                    _jax_draws(jcfg, k_n, n)))
    ref = jax.tree_util.tree_map(np.asarray, ref._asdict())
    out = occupancy_to_numpy(out)
    np.testing.assert_allclose(out["density_grid"], ref["density_grid"],
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(out["bitfield"], ref["bitfield"])
    np.testing.assert_allclose(out["mean_density"], ref["mean_density"], rtol=1e-5)
    assert int(out["ema_step"]) == int(ref["ema_step"]) == 1
    # the generator path draws its own samples and runs end to end
    gen = torch.Generator().manual_seed(0)
    again = tupd(_to_port(js), gen)
    assert again.density_grid.shape == (3, G, G, G)


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_march_and_render(aabb_scale):
    """march_rays_fused_plain (the fused march's CPU path and its kernel's
    oracle) + render_rays_ngp on the same grid, rays and field.
    The inverse-CDF bin of a sample can flip when its rank lands within
    float rounding of a bin edge, so require that 98% of rays agree exactly
    in validity and to 1e-4 in depth and colour."""
    jcfg, tcfg = _occ_cfgs(2 if aabb_scale == 4 else 0)
    js = _random_state(jcfg, 5)
    ts = _to_port(js)
    rcfg_kw = dict(aabb_scale=aabb_scale, n_coarse=64, n_samples=16,
                   near_distance=0.05)
    jr, tr = jnr.NGPRenderConfig(**rcfg_kw), tnr.NGPRenderConfig(**rcfg_kw)
    o, d = _rays(256, aabb_scale, 6)
    key = jax.random.PRNGKey(3)
    xi = np.array(jax.random.uniform(key, (256, 1)))
    jm_ = jnr.march_rays_fused(jcfg, jr, js, jnp.asarray(o), jnp.asarray(d), key)
    tm_ = tnr.march_rays_fused_plain(tcfg, tr, ts, torch.from_numpy(o),
                                     torch.from_numpy(d), torch.from_numpy(xi))
    jv, tv = np.asarray(jm_.valid), tm_.valid.numpy()
    assert 0.05 < jv.mean() < 0.95  # the grid both hits and misses
    same = (jv == tv).all(1) & (np.abs(np.asarray(jm_.t) - tm_.t.numpy())
                                < 1e-4).all(1)
    assert same.mean() >= 0.98
    np.testing.assert_allclose(tm_.positions.numpy()[same],
                               np.asarray(jm_.positions)[same], atol=1e-5)

    jm, params, tm = _models(aabb_scale)
    bg = np.asarray([1.0, 1.0, 1.0], np.float32)
    ref = jnr.render_rays_ngp(jcfg, jr, jm.apply, params, js, jnp.asarray(o),
                              jnp.asarray(d), jnp.asarray(bg))
    with torch.no_grad():
        out = tnr.render_rays_ngp(tcfg, tr, tm, ts, torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(bg))
    rgb_ok = (np.abs(out.rgb.numpy() - np.asarray(ref.rgb)) < 1e-4).all(1)
    assert rgb_ok.mean() >= 0.98
    assert np.asarray(ref.opacity).max() > 0.1  # the field is not transparent
    assert abs(int(out.n_samples) - int(ref.n_samples)) <= 0.02 * int(ref.n_samples)


@pytest.mark.parametrize("aabb_scale", [1, 4])
@pytest.mark.parametrize("needs_grad", [False, True])
def test_fused_march_runs_the_plain_path_on_cpu(aabb_scale, needs_grad):
    """march_rays_fused on CPU rays, whether or not they require grad, is
    march_rays_fused_plain bit for bit and launches no kernel; rays that
    require grad get a gradient through the march's t and dt."""
    jcfg, tcfg = _occ_cfgs(2 if aabb_scale == 4 else 0)
    ts = _to_port(_random_state(jcfg, 5))
    rcfg = tnr.NGPRenderConfig(aabb_scale=aabb_scale, n_coarse=64, n_samples=16,
                               near_distance=0.05)
    o, d = _rays(64, aabb_scale, 8)
    xi = torch.from_numpy(np.random.default_rng(9).uniform(0, 1, (64, 1)).astype(np.float32))
    ro = torch.from_numpy(o).requires_grad_(needs_grad)
    profiling.reset()
    got = tnr.march_rays_fused(tcfg, rcfg, ts, ro, torch.from_numpy(d), xi)
    want = tnr.march_rays_fused_plain(tcfg, rcfg, ts, torch.from_numpy(o),
                                      torch.from_numpy(d), xi)
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)
    assert got.valid.any() and not got.valid.all()
    assert profiling.counts()["launch.march_rays_fused"] == 0
    assert got.t.requires_grad == needs_grad
    if needs_grad:
        (torch.where(got.valid, got.t, 0.0).sum() + got.dt.sum()).backward()
        assert torch.isfinite(ro.grad).all() and ro.grad.abs().sum() > 0


@pytest.mark.parametrize("aabb_scale, n_coarse, K, const_dt, eps", [
    (1, 64, 16, True, 1e-4), (4, 512, 64, True, 1e-4), (4, 96, 20, False, 0.0),
    (3, 100, 18, False, 4.5e-3)])
def test_march_constants_are_the_plain_versions_f32_scalars(aabb_scale, n_coarse, K,
                                                             const_dt, eps):
    """The kernel's scalars: each an f32 value, each the plain version's
    Python number rounded to f32 (a division by a Python number on CUDA:
    f32 1 over the f32 number), the switches from the configs."""
    f32 = np.float32
    occ_cfg = tocc.OccupancyConfig(grid_size=32, n_cascades=3, max_cascade=2)
    rcfg = tnr.NGPRenderConfig(aabb_scale=aabb_scale, n_coarse=n_coarse, const_dt=const_dt)
    c = tnr.march_constants(occ_cfg, rcfg, K, eps)
    for name, _ in c._fields_:
        v = getattr(c, name)
        if isinstance(v, float):
            assert v == float(f32(v)), name
    lo, hi = rcfg.aabb
    assert (c.lo, c.hi, c.near) == (lo, hi, float(f32(0.2)))
    assert c.inv_coarse == float(f32(1) / f32(n_coarse))
    assert c.inv_samples == float(f32(1) / f32(K))
    assert c.inv_extent == float(f32(1) / f32(aabb_scale))
    assert c.dt_const == float(f32(rcfg.min_stepsize * 0.5))
    assert c.dt_max == float(f32(rcfg.min_stepsize * 4 * 1024 / 32))
    assert (c.single_mip, c.const_dt, c.truncate) == (aabb_scale == 1, const_dt, eps > 0)
    assert c.log_eps == (float(np.log(f32(eps))) if eps > 0 else 0.0)
    assert (c.n_coarse, c.n_samples, c.grid_size, c.n_cascades) == (n_coarse, K, 32, 3)


def test_march_kernel_wrapper_raises_on_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors or raises: it never falls
    back to the plain version (march_rays_fused chooses the path)."""
    from myc_nerfs_tpu_torch.ops.cuda import march as march_cuda

    jcfg, tcfg = _occ_cfgs(2)
    ts = _to_port(_random_state(jcfg, 5))
    rcfg = tnr.NGPRenderConfig(aabb_scale=4, n_coarse=64, n_samples=16)
    o, d = _rays(8, 4, 1)
    profiling.reset()
    with pytest.raises(ValueError, match="unsupported device"):
        march_cuda.march_fused(tnr.march_constants(tcfg, rcfg, 16, 1e-4), ts.density_grid,
                               ts.mean_density, torch.from_numpy(o), torch.from_numpy(d))
    assert profiling.counts()["launch.march_rays_fused"] == 0


def test_truncation_margin():
    """test_torch_cuda_march.truncation_margin (the card tests' bound on
    which rays may differ) is the least |logT_prev - log(eps)| over occupied
    bins, inf without truncation; rays that miss the box have no bin."""
    from test_torch_cuda_march import truncation_margin

    jcfg, tcfg = _occ_cfgs(2)
    ts = _to_port(_random_state(jcfg, 5))
    rcfg = tnr.NGPRenderConfig(aabb_scale=4, n_coarse=64, n_samples=16, near_distance=0.05)
    o, d = _rays(32, 4, 3)
    d[:4] = -d[:4]  # aimed away from the box: span 0
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    m = truncation_margin(tcfg, rcfg, ts, o, d)
    _, span, _, _, occ_c, logT = tnr._coarse_pass(tcfg, rcfg, ts, o, d)
    log_eps = float(np.log(np.float32(1e-4)))
    for i in range(32):
        gaps = (logT[i] - log_eps).abs()[occ_c[i]]
        assert m[i] == (gaps.min() if gaps.numel() else float("inf"))
    assert torch.isinf(truncation_margin(tcfg, rcfg, ts, o, d, trunc_eps=0.0)).all()
    assert torch.isfinite(m).any()


def test_compositors():
    """composite_weights/rgb (NGP), composite_nerf and raw2alpha: the same
    scans in f32 (atol 1e-5 on values in [0, 1])."""
    rng = np.random.default_rng(12)
    sigma = rng.uniform(0, 30, (64, 24)).astype(np.float32)
    dt = rng.uniform(0, 0.05, (64, 24)).astype(np.float32)
    valid = rng.uniform(0, 1, (64, 24)) > 0.2
    rgb = rng.uniform(0, 1, (64, 24, 3)).astype(np.float32)
    bg = np.asarray([0.2, 0.5, 1.0], np.float32)
    jw, jt = jcomp.composite_weights(jnp.asarray(sigma), jnp.asarray(dt),
                                     jnp.asarray(valid), 1e-3)
    tw, tt = tcomp.composite_weights(torch.from_numpy(sigma), torch.from_numpy(dt),
                                     torch.from_numpy(valid), 1e-3)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_allclose(
        tcomp.composite_rgb(torch.from_numpy(rgb), tw, tt, torch.from_numpy(bg)).numpy(),
        np.asarray(jcomp.composite_rgb(jnp.asarray(rgb), jw, jt, jnp.asarray(bg))),
        atol=1e-5)
    ray = rng.standard_normal((64, 3)).astype(np.float32)
    depth = np.sort(rng.uniform(1, 4, (64, 24, 1)), axis=1).astype(np.float32)
    dens = sigma / 10
    ref = jcomp.composite_nerf(jnp.asarray(ray), jnp.asarray(rgb), jnp.asarray(dens),
                               jnp.asarray(depth), jnp.asarray(bg))
    out = tcomp.composite_nerf(torch.from_numpy(ray), torch.from_numpy(rgb),
                               torch.from_numpy(dens), torch.from_numpy(depth),
                               torch.from_numpy(bg))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for a, b in zip(tcomp.raw2alpha(torch.from_numpy(dens), torch.from_numpy(dt)),
                    jcomp.raw2alpha(jnp.asarray(dens), jnp.asarray(dt))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
