"""Port parity of the TensoRF models against the JAX package (every sample
budget at 0, factor_gather_bf16 off: the JAX forward that equals the
reference's boolean indexing): the density and appearance features of
vm_split, vm and cp; tensorf_forward with and without an alpha mask (the
corner-dilated lookup, the trilinear one) and with NDC rays;
ref_tensorf_forward (Fea and SH) with its penalty and normals;
nerfpp_forward; the alpha-mask update, shrink, upsample and the
regularisers. Small grids (10-15 voxels a side), the same numpy-seeded
weights and JAX-drawn jitter in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import nerfpp as jpp, ref_tensorf as jref, tensorf as jtf
from myc_nerfs_tpu_torch.core.bridge import load_tensorf_params, tensorf_params_tree
from myc_nerfs_tpu_torch.models import nerfpp as tpp, ref_tensorf as tref, tensorf as ttf

torch.set_num_threads(1)

AABB = np.asarray([[-1.2, -1.1, -1.0], [1.2, 1.0, 1.1]], np.float32)
GRID = (13, 11, 12)
# outputs: f32 math in another operation order (the lerp weights, the sum
# over components, the MLP's GEMMs). The JAX forwards run op by op, as the
# port's do: under jit XLA fuses o + d * z into one multiply-add, which
# moves a sample that lies on the AABB's face (an unjittered ray's first)
# to the other side of it in either package
RTOL, ATOL = 1e-5, 1e-6


def model_cfgs(decomp="vm_split", shading="MLP_Fea", **kw):
    comps = dict(vm_split=((3, 4, 5), (6, 5, 4)), vm=((4,), (6,)), cp=((6,), (8,)))[decomp]
    common = dict(decomp=decomp, density_n_comp=comps[0], app_n_comp=comps[1], app_dim=9
                  if shading in ("MLP_Fea", "MLP_PE", "MLP") else (27 if shading == "SH" else 3),
                  shading_mode=shading, featureC=16, view_pe=2, fea_pe=2, pos_pe=2,
                  density_shift=-1.0, ray_march_weight_thres=1e-3, alpha_mask_thres=2e-2,
                  near_far=(1.0, 5.0), step_ratio=0.6)
    common.update(kw)
    return (jtf.TensoRFConfig(**common, density_sample_budget=0, app_sample_budget=0,
                              density_batch_budget=0, factor_gather_bf16=False),
            ttf.TensoRFConfig(**common))


def grid_of(decomp):
    return (GRID[0],) * 3 if decomp == "vm" else GRID


def make_params(jcfg, tcfg, family="base", pp=None, seed=0):
    """JAX params (init_tensorf, factor grids scaled up to O(1) so density
    and appearance vary) and the port's holding the same values."""
    gs = grid_of(jcfg.decomp)
    jp, jb = jtf.init_tensorf(jax.random.PRNGKey(seed), jcfg, AABB, gs)
    jp = dict(jp)
    for k in jp:
        if k.endswith(("_plane", "_line")):
            jp[k] = tuple(8.0 * v for v in jp[k])
    tp, tb = ttf.init_tensorf(tcfg, AABB, gs, torch.Generator().manual_seed(seed), "cpu")
    if family == "ref":
        jp = jref.init_ref_heads(jax.random.PRNGKey(seed + 1), jcfg, jp)
        tp = tref.init_ref_heads(tcfg, tp, "cpu", torch.Generator().manual_seed(1))
    if family == "nerfpp":
        jp["bg_net"] = jpp.init_nerfpp(jax.random.PRNGKey(seed + 2), pp[0])
        tp["bg_net"] = tpp.BgMLPNet(pp[1], "cpu", torch.Generator().manual_seed(2))
    tp = load_tensorf_params(tp, jax.tree_util.tree_map(np.asarray, jp))
    return (jp, jb), (tp, tb)


def make_rays(n, seed=0, radius=3.2):
    """Rays from a sphere toward the box (some miss it), unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.uniform(-1.2, 1.2, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


def alpha_volume(seed=0, shape=(9, 10, 8)):
    """A binary [D, H, W] mask: a random blob field thresholded."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    f = np.sin(3 * x + rng.uniform(0, 6)) * np.cos(2 * y) + 0.8 * z
    return (f > 0.1).astype(np.float32)


def install_mask(jb, tb, mode):
    """The same alpha volume in both buffers: "dil" (the corner-dilated
    lookup), "tri" (the trilinear lookup: no dilated volume) or None."""
    if mode is None:
        return jb, tb
    vol = alpha_volume()
    jb = jtf.prepare_alpha_buffers({**jb, "alpha_volume": jnp.asarray(vol)})
    tb = ttf.prepare_alpha_buffers({**tb, "alpha_volume": torch.from_numpy(vol)})
    if mode == "tri":
        jb["alpha_volume_dil"] = None
        tb["alpha_volume_dil"] = None
    return jb, tb


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("decomp", ["vm_split", "vm", "cp"])
def test_features_match_jax(decomp):
    """compute_density_feature and compute_app_feature at random
    normalised coords (past the border too)."""
    jcfg, tcfg = model_cfgs(decomp)
    (jp, _), (tp, _) = make_params(jcfg, tcfg)
    xyz = np.random.default_rng(1).uniform(-1.05, 1.05, (500, 3)).astype(np.float32)
    jd, ja = jax.jit(lambda p, x: (jtf.compute_density_feature(jcfg, p, x),
                                   jtf.compute_app_feature(jcfg, p, x)))(jp, jnp.asarray(xyz))
    close(ttf.compute_density_feature(tcfg, tp, torch.from_numpy(xyz)), jd, atol=1e-5)
    close(ttf.compute_app_feature(tcfg, tp, torch.from_numpy(xyz)), ja, atol=1e-5)


def check_out(t, j, extras=("valid", "app_mask")):
    """rgb, depth, weight, sigma, z_vals close; the masks exact."""
    for name in ("rgb_map", "depth_map", "weight", "sigma", "z_vals"):
        close(getattr(t, name), getattr(j, name))
    for name in extras:
        np.testing.assert_array_equal(t.extras[name].numpy(), np.asarray(j.extras[name]))
    assert 0 < int(t.extras["app_mask"].sum()) < t.extras["app_mask"].numel()


CASES = [("vm_split", "MLP_Fea", None, False), ("vm_split", "MLP_Fea", "dil", False),
         ("vm_split", "SH", "tri", False), ("vm", "MLP_PE", "dil", False),
         ("cp", "RGB", None, False), ("cp", "MLP", "dil", False),
         ("vm_split", "MLP_Fea", None, True)]


@pytest.mark.parametrize("decomp,shading,mask,ndc", CASES)
def test_tensorf_forward_matches_jax(decomp, shading, mask, ndc):
    """tensorf_forward on 64 rays with JAX-drawn jitter ([N, 1], NDC [N, S]),
    and (the first case) unjittered; white background."""
    jcfg, tcfg = model_cfgs(decomp, shading)
    (jp, jb), (tp, tb) = make_params(jcfg, tcfg)
    jb, tb = install_mask(jb, tb, mask)
    geom = jtf.compute_stage_geom(jcfg, AABB, grid_of(decomp))
    assert ttf.compute_stage_geom(tcfg, AABB, grid_of(decomp)) == tuple(geom)
    rays = make_rays(64)
    key = jax.random.PRNGKey(3)
    for k in ((key, None) if (decomp, shading, mask, ndc) == CASES[0] else (key,)):
        j = jtf.tensorf_forward(jcfg, geom, jp, jb, jnp.asarray(rays), k, ndc_ray=ndc)
        jit = None
        if k is not None:
            jit = np.array(jax.random.uniform(k, (64, geom.n_samples) if ndc else (64, 1)))
        with torch.no_grad():
            t = ttf.tensorf_forward(tcfg, geom, tp, tb, torch.from_numpy(rays),
                                    None if jit is None else torch.from_numpy(jit), ndc_ray=ndc)
        check_out(t, j)


@pytest.mark.parametrize("shading,mask", [("MLP_Fea", None), ("MLP_Fea", "dil"), ("SH", "dil")])
def test_ref_forward_matches_jax(shading, mask):
    """ref_tensorf_forward: outputs, masks, the normal penalty and the
    normals of the shaded samples."""
    jcfg, tcfg = model_cfgs("vm_split", shading)
    (jp, jb), (tp, tb) = make_params(jcfg, tcfg, "ref")
    jb, tb = install_mask(jb, tb, mask)
    geom = jtf.compute_stage_geom(jcfg, AABB, GRID)
    rays = make_rays(64, seed=1)
    key = jax.random.PRNGKey(4)
    j = jref.ref_tensorf_forward(jcfg, geom, jp, jb, jnp.asarray(rays), key)
    with torch.no_grad():
        t = tref.ref_tensorf_forward(tcfg, geom, tp, tb, torch.from_numpy(rays),
                                     torch.from_numpy(np.array(jax.random.uniform(key, (64, 1)))))
    check_out(t, j)
    close(t.extras["penalty"], j.extras["penalty"])
    assert float(t.extras["penalty"]) > 0
    sel = np.asarray(j.extras["app_mask"]).reshape(-1)
    close(t.extras["normal"], np.asarray(j.extras["normal"]).reshape(-1, 3)[sel])


@pytest.mark.parametrize("mask", [None, "dil"])
def test_nerfpp_forward_matches_jax(mask):
    """nerfpp_forward (bg_D 3, skip at 1) with the fg / bg draws of
    split(key), and unjittered: outputs, masks and the background map."""
    pp = dict(bg_freq=2, bg_view_freq=2, bg_D=3, radii=3.0, bg_samples=24)
    jcfg, tcfg = model_cfgs("vm_split")
    jppc, tppc = jpp.NerfPPConfig(**pp), tpp.NerfPPConfig(**pp)
    (jp, jb), (tp, tb) = make_params(jcfg, tcfg, "nerfpp", (jppc, tppc))
    jb, tb = install_mask(jb, tb, mask)
    geom = jtf.compute_stage_geom(jcfg, AABB, GRID)
    rays = make_rays(48, seed=2, radius=2.0)
    key = jax.random.PRNGKey(5)
    for k in ((key, None) if mask is None else (key,)):
        # compiled: its samples start at `near`, not on the AABB's face
        j = jax.jit(lambda p, b, r, k: jpp.nerfpp_forward(jcfg, jppc, geom, p, b, r, k))(
            jp, jb, jnp.asarray(rays), k)
        draws = None
        if k is not None:
            k_fg, k_bg = jax.random.split(k)
            draws = (torch.from_numpy(np.array(jax.random.uniform(k_fg, (48, geom.n_samples)))),
                     torch.from_numpy(np.array(jax.random.uniform(k_bg, (48, pp["bg_samples"])))))
        with torch.no_grad():
            t = tpp.nerfpp_forward(tcfg, tppc, geom, tp, tb, torch.from_numpy(rays), draws)
        check_out(t, j)
        close(t.bg_weight, j.bg_weight)
        close(t.extras["bg_rgb_map"], j.extras["bg_rgb_map"])


@pytest.mark.parametrize("decomp,mask", [("vm_split", None), ("vm_split", "dil"), ("cp", None)])
def test_update_alpha_mask_matches_jax(decomp, mask):
    """update_alpha_mask at a (14, 9, 11) alpha grid: the dense alpha within
    1e-6 (JAX's runs compiled under lax.map; 1 - exp(-x) cancels); the binary volume equal except at voxels whose
    pooled alpha lies within 1e-5 of the threshold (excluded and counted:
    none here); the new aabb equal. The threshold sits inside the pooled
    alpha's range, so the mask is neither empty nor full."""
    jcfg, tcfg = model_cfgs(decomp, alpha_mask_thres=0.7 if decomp == "cp" else 0.2)
    (jp, jb), (tp, tb) = make_params(jcfg, tcfg)
    jb, tb = install_mask(jb, tb, mask)
    geom = jtf.compute_stage_geom(jcfg, AABB, grid_of(decomp))
    reso = (14, 9, 11)
    ja, jxyz = jtf.get_dense_alpha(jcfg, geom, jp, jb, reso)
    ta, txyz = ttf.get_dense_alpha(tcfg, geom, tp, tb, reso)
    np.testing.assert_array_equal(txyz.numpy(), np.asarray(jxyz))
    close(ta, ja, rtol=1e-5, atol=1e-6)
    jb2, jaabb = jtf.update_alpha_mask(jcfg, geom, jp, jb, reso)
    tb2, taabb = ttf.update_alpha_mask(tcfg, geom, tp, tb, reso)
    pooled = torch.nn.functional.max_pool3d(
        torch.from_numpy(np.clip(np.asarray(ja), 0, 1)).permute(2, 1, 0)[None, None], 3, 1, 1)[0, 0]
    near = (pooled - jcfg.alpha_mask_thres).abs() <= 1e-5
    assert int(near.sum()) == 0
    jvol = np.asarray(jb2["alpha_volume"])
    assert 0 < jvol.sum() < jvol.size
    np.testing.assert_array_equal(tb2["alpha_volume"].numpy(), jvol)
    np.testing.assert_array_equal(tb2["alpha_volume_dil"].numpy(),
                                  np.asarray(jb2["alpha_volume_dil"]))
    np.testing.assert_array_equal(taabb, np.asarray(jaabb))


@pytest.mark.parametrize("decomp", ["vm_split", "vm", "cp"])
def test_shrink_upsample_match_jax(decomp):
    """shrink to a tighter aabb (slices and aabb exact), with the alpha
    grid's resolution equal to the model's (the raw aabb) and not (snapped
    to the lattice); then upsample_volume_grid (bilinear, align_corners;
    F.interpolate against the JAX resize: 1e-5)."""
    jcfg, tcfg = model_cfgs(decomp)
    (jp, jb), (tp, tb) = make_params(jcfg, tcfg)
    gs = grid_of(decomp)
    geom = jtf.compute_stage_geom(jcfg, AABB, gs)
    new_aabb = np.asarray([[-0.71, -0.52, -0.83], [0.9, 0.61, 0.33]], np.float32)
    for vol_shape in (gs[::-1], (5, 6, 7)):
        vol = np.ones(vol_shape, np.float32)
        jbm = {**jb, "alpha_volume": jnp.asarray(vol)}
        tbm = {**tb, "alpha_volume": torch.from_numpy(vol)}
        jp2, jb2, jsize = jtf.shrink(jcfg, geom, jp, jbm, new_aabb)
        tp2, tb2, tsize = ttf.shrink(tcfg, geom, tp, tbm, new_aabb)
        assert tsize == jsize
        np.testing.assert_array_equal(tb2["aabb"].numpy(), np.asarray(jb2["aabb"]))
        jt, tt_ = (jax.tree_util.tree_map(np.asarray, jp2), tensorf_params_tree(tp2))
        for k in jt:
            if k.endswith(("_plane", "_line")):
                for i in range(3):
                    np.testing.assert_array_equal(tt_[k][str(i)], jt[k][i])
    res = [int(r * 1.7) for r in (gs if decomp != "vm" else (gs[0],) * 3)]
    jup = jax.jit(lambda p: jtf.upsample_volume_grid(jcfg, p, res))(jp)
    tup = tensorf_params_tree(ttf.upsample_volume_grid(tcfg, tp, res))
    for k in jup:
        if k.endswith(("_plane", "_line")):
            for i in range(3):
                close(tup[k][str(i)], jup[k][i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("decomp", ["vm_split", "vm", "cp"])
def test_regularisers_match_jax(decomp):
    """vector_comp_diffs, density_L1, tv_loss_density / tv_loss_app (CP's
    are NaN in both: its lines have no W extent), filter_rays_bbox."""
    jcfg, tcfg = model_cfgs(decomp)
    (jp, _), (tp, _) = make_params(jcfg, tcfg)
    ref = jax.jit(lambda p: (jtf.vector_comp_diffs(p), jtf.density_L1(jcfg, p),
                             jtf.tv_loss_density(jcfg, p), jtf.tv_loss_app(jcfg, p)))(jp)
    out = (ttf.vector_comp_diffs(tp), ttf.density_L1(tcfg, tp), ttf.tv_loss_density(tcfg, tp),
           ttf.tv_loss_app(tcfg, tp))
    for a, b in zip(out, ref):
        close(a, b)
    rays = make_rays(200, seed=7, radius=4.0)
    np.testing.assert_array_equal(ttf.filter_rays_bbox(torch.from_numpy(AABB),
                                                       torch.from_numpy(rays)).numpy(),
                                  np.asarray(jtf.filter_rays_bbox(jnp.asarray(AABB),
                                                                  jnp.asarray(rays))))
