"""Port parity of the NeRF MLP family: NeRFMLP for nerf, barf (the c2f mask
at three progress values), garf and bf16 products, its density heads and
density noise, its parameter gradients, its init, and the bridge that
carries flax's ``Dense_i`` trees (and fine sampling's coarse/fine pair)
into myc_nerfs_tpu_torch and back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import nerf_mlp as jmlp
from myc_nerfs_tpu_torch.core.bridge import nerf_params_from_numpy, nerf_params_to_numpy
from myc_nerfs_tpu_torch.models import nerf_mlp as tmlp

torch.set_num_threads(1)

SMALL = dict(widths_feat=(32,) * 4, widths_rgb=(16, 3), skip=(2,))
CASES = {
    "nerf": dict(posenc_L3D=4, posenc_Lview=2),
    "nerf_skip0_relu": dict(posenc_L3D=3, posenc_Lview=None, skip=(0, 3), density_activ="relu"),
    "nerf_no_view": dict(posenc_L3D=3, posenc_Lview=2, view_dep=False, density_activ="abs"),
    "nerf_exp": dict(posenc_L3D=3, posenc_Lview=2, density_activ="exp"),
    "nerf_sigmoid": dict(posenc_L3D=3, posenc_Lview=2, density_activ="sigmoid"),
    "garf": dict(posenc_L3D=None, posenc_Lview=None, activation="gaussian",
                 density_activ="relu", skip=(3,)),
}


def _models(kw, seed=0):
    """A JAX NeRFMLP with initialised params and the port's with the same
    weights (through the bridge)."""
    kw = {**SMALL, **kw}
    jm = jmlp.NeRFMLP(**kw)
    pts = jnp.zeros((1, 4, 3))
    params = jm.init(jax.random.PRNGKey(seed), pts, pts if kw.get("view_dep", True) else None)
    tm = tmlp.NeRFMLP(**kw)
    nerf_params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _inputs(seed=1, shape=(2, 5, 8)):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, shape + (3,)).astype(np.float32)
    d = rng.standard_normal(shape + (3,)).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    """(rgb, density) on [2, 5, 8] samples (rtol 1e-5, atol 1e-5 of O(1)
    outputs: 4-layer f32 products summed in another order)."""
    jm, params, tm = _models(CASES[name])
    pts, d = _inputs()
    view = d if tm.view_dep else None
    rgb_j, den_j = jm.apply(params, jnp.asarray(pts), None if view is None else jnp.asarray(view))
    rgb_t, den_t = tm(torch.from_numpy(pts), None if view is None else torch.from_numpy(view))
    assert rgb_t.shape == (2, 5, 8, 3) and den_t.shape == (2, 5, 8)
    np.testing.assert_allclose(rgb_t.detach().numpy(), rgb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(den_t.detach().numpy(), den_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("progress", [0.05, 0.3, 0.6])
def test_barf_c2f_forward_matches_jax(progress):
    """BARF: the c2f mask on both encodings at progress before, inside and
    after the [0.1, 0.5] ramp, with density noise from a JAX normal draw
    passed to the port (rtol 1e-5, atol 1e-5)."""
    jm, params, tm = _models(dict(posenc_L3D=6, posenc_Lview=3))
    pts, d = _inputs(2)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, pts.shape[:-1]))
    rgb_j, den_j = jm.apply(params, jnp.asarray(pts), jnp.asarray(d),
                            progress=jnp.float32(progress), c2f=(0.1, 0.5),
                            density_noise=0.3, noise_key=key)
    rgb_t, den_t = tm(torch.from_numpy(pts), torch.from_numpy(d),
                      progress=torch.tensor(progress, dtype=torch.float32), c2f=(0.1, 0.5),
                      density_noise=0.3, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(rgb_t.detach().numpy(), rgb_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(den_t.detach().numpy(), den_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["nerf", "garf"])
def test_gradients_match_jax(name):
    """Every parameter's gradient of a weighted sum of rgb and density, and
    the points' gradient: within 1e-5 of each tensor's scale for nerf, 2e-4
    for garf (the gaussian's 1/sigma^2 = 100 scales each pre-activation's
    f32 rounding into the gradient; the points' gradient reaches ~500
    there)."""
    jm, params, tm = _models(CASES[name])
    tol = 2e-4 if name == "garf" else 1e-5
    pts, d = _inputs(3)
    rng = np.random.default_rng(4)
    w_rgb = rng.standard_normal(pts.shape).astype(np.float32)
    w_den = rng.standard_normal(pts.shape[:-1]).astype(np.float32)

    def jloss(p, x):
        rgb, den = jm.apply(p, x, jnp.asarray(d))
        return (rgb * w_rgb).sum() + (den * w_den).sum()

    gp_j, gx_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    rgb, den = tm(x, torch.from_numpy(d))
    params_t = tm.param_list()
    grads = torch.autograd.grad((rgb * torch.from_numpy(w_rgb)).sum()
                                + (den * torch.from_numpy(w_den)).sum(), params_t + [x])
    ref = nerf_params_to_numpy(tm)  # the tree layout, filled from JAX's grads below
    gp_j = jax.tree_util.tree_map(np.asarray, gp_j)
    for (layer, kind), g in zip(tm.leaf_names(), grads[:-1]):
        b = gp_j["params"][layer][kind]
        assert ref["params"][layer][kind].shape == b.shape
        np.testing.assert_allclose(g.numpy(), b, rtol=0, atol=tol * np.abs(b).max())
    np.testing.assert_allclose(grads[-1].numpy(), gx_j, rtol=0,
                               atol=tol * np.abs(np.asarray(gx_j)).max())


@pytest.mark.parametrize("name", ["nerf", "garf"])
def test_bf16_forward_matches_jax(name):
    """use_bf16: products in bf16, params f32, gaussian and heads in f32.
    Against the JAX bf16 model: within 2^-5 absolute of the O(1) rgb and of
    the density scale (a few bf16 ulps carried through four layers; the
    gaussian amplifies an input ulp 100x in the garf case). The nerf case's
    rgb also lies within 2^-4 of the f32 model's; garf's does not (0.22
    here: bf16 inputs to a sigma 0.1 gaussian), which is why the JAX
    package gates bf16 GARF by quality (scripts/garf_bf16.py)."""
    kw = {**CASES[name], "use_bf16": True}
    jm, params, tm = _models(kw)
    pts, d = _inputs(5)
    rgb_j, den_j = jm.apply(params, jnp.asarray(pts), jnp.asarray(d))
    rgb_t, den_t = tm(torch.from_numpy(pts), torch.from_numpy(d))
    assert rgb_t.dtype == torch.float32 and den_t.dtype == torch.float32
    scale = max(1.0, float(np.abs(np.asarray(den_j)).max()))
    np.testing.assert_allclose(rgb_t.detach().numpy(), rgb_j, atol=2.0 ** -5)
    np.testing.assert_allclose(den_t.detach().numpy(), den_j, atol=2.0 ** -5 * scale)
    if name == "nerf":
        tm.use_bf16 = False
        rgb_f, _ = tm(torch.from_numpy(pts), torch.from_numpy(d))
        np.testing.assert_allclose(rgb_t.detach().numpy(), rgb_f.detach().numpy(),
                                   atol=2.0 ** -4)


def test_init_and_tree_layout():
    """The port's init: every kernel inside its TF Xavier bound (relu gain on
    hidden layers, 1 on the rgb output, column 0 of the density layer over
    its own slice), biases zero, the same tree shapes as flax's; and a
    params tree survives the bridge both ways, fine sampling's coarse/fine
    pair included."""
    kw = {**SMALL, **CASES["nerf"]}
    jparams = jmlp.NeRFMLP(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 3)),
                                     jnp.zeros((1, 1, 3)))
    tm = tmlp.NeRFMLP(**kw, generator=torch.Generator().manual_seed(3))
    tree = nerf_params_to_numpy(tm)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams)))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jparams)):
        assert a.shape == b.shape
    n_feat = len(SMALL["widths_feat"])
    for i, k in enumerate(tm.kernels):
        k = k.detach().numpy()
        fan_in, fan_out = k.shape
        assert not tm.biases[i].detach().any()
        if i == n_feat - 1:
            assert np.abs(k[:, 0]).max() <= np.sqrt(6.0 / (fan_in + 1))
            assert np.abs(k[:, 1:]).max() <= np.sqrt(2.0) * np.sqrt(6.0 / (fan_in + fan_out - 1))
        else:
            gain = 1.0 if i == len(tm.kernels) - 1 else np.sqrt(2.0)
            bound = gain * np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(k).max() <= bound and np.abs(k).max() > 0.5 * bound
    pair = tmlp.CoarseFine(tmlp.NeRFMLP(**kw), tmlp.NeRFMLP(**kw))
    both = {"coarse": jax.tree_util.tree_map(np.asarray, jparams), "fine": tree}
    nerf_params_from_numpy(pair, both)
    back = nerf_params_to_numpy(pair)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(both)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        nerf_params_from_numpy(tm, both)
