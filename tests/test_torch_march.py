"""Port parity of the non-fused march (render/ngp_render.py): compact_first_k,
the bitfield march march_rays, compact_marched and render_rays_ngp with
fused_march=False (compaction from the grid and from the network's detached
density) against the JAX package, with the JAX side's jitter given as xi."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import ngp as jngp
from myc_nerfs_tpu.ops import compaction as jcomp
from myc_nerfs_tpu.render import ngp_render as jnr
from myc_nerfs_tpu.render import occupancy as jocc
from myc_nerfs_tpu_torch.core.bridge import load_ngp_params, occupancy_from_numpy
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.ops import compaction as tcomp
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.render import occupancy as tocc

torch.set_num_threads(1)

G = 32
DEMO_GRID = dict(n_levels=8, log2_hashmap_size=15, desired_resolution=256.0)


def _state(aabb_scale, seed=5):
    kw = dict(grid_size=G, n_cascades=3, max_cascade=2 if aabb_scale == 4 else 0)
    jcfg, tcfg = jocc.OccupancyConfig(**kw), tocc.OccupancyConfig(**kw)
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (3, G, G, G)).astype(np.float32)
    grid = np.where(u > 0.55, 0.08 * u, 0.0).astype(np.float32)
    grid[rng.uniform(0, 1, grid.shape) < 0.05] = -1.0
    bits, mean = jocc.update_bitfield(jcfg, jnp.asarray(grid))
    js = jocc.OccupancyState(density_grid=jnp.asarray(grid), bitfield=bits,
                             mean_density=mean, ema_step=jnp.zeros((), jnp.int32))
    ts = occupancy_from_numpy(jax.tree_util.tree_map(np.asarray, js._asdict()))
    return jcfg, tcfg, js, ts


def _rays(n, aabb_scale, seed):
    rng = np.random.default_rng(seed)
    lo, hi = 0.5 - aabb_scale / 2, 0.5 + aabb_scale / 2
    o = rng.standard_normal((n, 3))
    o = 0.5 + o / np.linalg.norm(o, axis=-1, keepdims=True) * aabb_scale * 1.2
    d = rng.uniform(lo, hi, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("k", [1, 8, 40, 64])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_compact_first_k_matches_jax(k, density):
    mask = np.random.default_rng(k).uniform(0, 1, (6, 5, 40)) < density
    ji, jv = jcomp.compact_first_k(jnp.asarray(mask), k)
    ti, tv = tcomp.compact_first_k(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _marches(aabb_scale, n=256):
    jcfg, tcfg, js, ts = _state(aabb_scale)
    kw = dict(aabb_scale=aabb_scale, n_coarse=64, n_samples=16, near_distance=0.05)
    jr, tr = jnr.NGPRenderConfig(**kw), tnr.NGPRenderConfig(**kw)
    o, d = _rays(n, aabb_scale, 6)
    key = jax.random.PRNGKey(3)
    xi = np.array(jax.random.uniform(key, (n, 1)))
    jm = jnr.march_rays(jcfg, jr, js.bitfield, jnp.asarray(o), jnp.asarray(d), key)
    tm = tnr.march_rays(tcfg, tr, ts.bitfield, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(xi))
    return jm, tm


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_march_rays_matches_jax(aabb_scale):
    """The bitfield march with the JAX jitter: every output exactly equal
    (the same f32 operations in the same order; the bin search by
    searchsorted counts the same cumulative sums as JAX's compare-and-sum)."""
    jm, tm = _marches(aabb_scale)
    assert 0.05 < np.asarray(jm.valid).mean() < 0.95  # the grid hits and misses
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_compact", [4, 16, 24])
def test_compact_marched_matches_jax(n_compact):
    """compact_marched on the same march and detached density: exact."""
    jm, _ = _marches(1)
    rng = np.random.default_rng(n_compact)
    sigma = rng.uniform(0, 400, np.asarray(jm.valid).shape).astype(np.float32)
    ref = jnr.compact_marched(jm, jnp.asarray(sigma), n_compact, 1e-4)
    tmar = tnr.MarchedRays(*[torch.from_numpy(np.array(a)) for a in jm])
    out = tnr.compact_marched(tmar, torch.from_numpy(sigma), n_compact, 1e-4)
    assert np.asarray(ref.valid).any() and not np.asarray(ref.valid).all()
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("source", ["grid", "network"])
@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_render_rays_non_fused_matches_jax(source, aabb_scale):
    """render_rays_ngp with fused_march=False and n_compact 8 in training
    (density_apply given): the 'hash' grid (quality_scale's hash variant)
    and the compaction source of the config. rgb 1e-5 (the same field on
    the same samples; sums in another order), the valid sample count
    exactly; and the gradient of the loss w.r.t. the MLP weights, 1e-4 of
    scale."""
    jcfg, tcfg, js, ts = _state(aabb_scale)
    mj = jngp.NGPModelConfig(grid=jngp.HashGridConfig(aabb_scale=aabb_scale, **DEMO_GRID),
                             grid_impl="hash")
    mt = tngp.NGPModelConfig(grid=tngp.HashGridConfig(aabb_scale=aabb_scale, **DEMO_GRID),
                             grid_impl="hash")
    jmodel = jngp.NGPModel(mj)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = {"table": jnp.asarray(rng.uniform(-1, 1, params["table"].shape), jnp.float32),
              "mlp": params["mlp"]}
    tmodel = tngp.NGPModel(mt)
    load_ngp_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    kw = dict(aabb_scale=aabb_scale, n_coarse=64, n_samples=16, n_compact=8,
              near_distance=0.05, fused_march=False, compact_source=source)
    jr, tr = jnr.NGPRenderConfig(**kw), tnr.NGPRenderConfig(**kw)
    o, d = _rays(128, aabb_scale, 7)
    bg = np.asarray([1.0, 1.0, 1.0], np.float32)
    key = jax.random.PRNGKey(4)
    xi = np.array(jax.random.uniform(key, (128, 1)))
    tgt = rng.uniform(0, 1, (128, 3)).astype(np.float32)

    def jloss(p):
        out = jnr.render_rays_ngp(jcfg, jr, jmodel.apply, p, js, jnp.asarray(o),
                                  jnp.asarray(d), jnp.asarray(bg), key,
                                  density_apply=jmodel.density_raw)
        return ((out.rgb - tgt) ** 2).mean(), out

    (_, ref), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tnr.render_rays_ngp(tcfg, tr, tmodel, ts, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(bg), torch.from_numpy(xi),
                              density_apply=tmodel.density_raw)
    assert int(out.n_samples) == int(ref.n_samples) > 128
    np.testing.assert_allclose(out.rgb.detach().numpy(), np.asarray(ref.rgb), atol=1e-5)
    loss = ((out.rgb - torch.from_numpy(tgt)) ** 2).mean()
    names = tngp.NGPNetwork.LAYERS
    grads = torch.autograd.grad(loss, [getattr(tmodel.net, n) for n in names])
    for n, g in zip(names, grads):
        want = np.asarray(jg["mlp"]["params"][n]["kernel"])
        assert np.abs(g.numpy() - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-6), n


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_render_rays_non_fused_inference_matches_jax(aabb_scale):
    """The non-fused render without density_apply (render_image's path:
    n_samples per ray from the bitfield march at the jitter's midpoint, no
    compaction): rgb and depth 1e-5, the valid sample count exactly."""
    jcfg, tcfg, js, ts = _state(aabb_scale, seed=9)
    mj = jngp.NGPModelConfig(grid=jngp.HashGridConfig(aabb_scale=aabb_scale, **DEMO_GRID),
                             grid_impl="hash")
    mt = tngp.NGPModelConfig(grid=tngp.HashGridConfig(aabb_scale=aabb_scale, **DEMO_GRID),
                             grid_impl="hash")
    jmodel = jngp.NGPModel(mj)
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = tngp.NGPModel(mt)
    load_ngp_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    rk = dict(aabb_scale=aabb_scale, n_coarse=64, n_samples=24, n_compact=8,
              near_distance=0.05, fused_march=False, compact_source="network")
    o, d = _rays(96, aabb_scale, 11)
    bg = np.asarray([1.0, 1.0, 1.0], np.float32)
    ref = jnr.render_rays_ngp(jcfg, jnr.NGPRenderConfig(**rk), jmodel.apply, params, js,
                              jnp.asarray(o), jnp.asarray(d), jnp.asarray(bg), None)
    with torch.no_grad():
        out = tnr.render_rays_ngp(tcfg, tnr.NGPRenderConfig(**rk), tmodel, ts,
                                  torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(bg))
    assert int(out.n_samples) == int(ref.n_samples) > 96
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), atol=1e-5)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), atol=1e-5)
