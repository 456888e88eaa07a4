"""Port parity of the MLP family's renderer: the depth samplers
(stratified, inverse-CDF from a pdf, hierarchical over bin edges), the
coarse and the coarse -> fine render of rays with their gradients (the fine
pass keeps the gradient through the inverse-CDF depths and the sort), and
the whole-image chunked render, each of myc_nerfs_tpu_torch against
myc_nerfs_tpu on the same numpy inputs, weights and JAX-drawn jitter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.models import nerf_mlp as jmlp
from myc_nerfs_tpu.render import mlp_renderer as jrender
from myc_nerfs_tpu.render import sampling as jsamp
from myc_nerfs_tpu_torch.core.bridge import nerf_params_from_numpy
from myc_nerfs_tpu_torch.models import nerf_mlp as tmlp
from myc_nerfs_tpu_torch.render import mlp_renderer as trender
from myc_nerfs_tpu_torch.render import sampling as tsamp

torch.set_num_threads(1)

ARCH = dict(widths_feat=(32,) * 4, widths_rgb=(16, 3), skip=(2,), posenc_L3D=4,
            posenc_Lview=2)
DEPTH = (1.5, 4.5)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("stratified,param", [(True, "metric"), (False, "metric"),
                                              (True, "inverse")])
def test_sample_depth_matches_jax(stratified, param):
    """Bins (i + u) / N over the range with the JAX-drawn u, or midpoints
    (rtol 1e-6)."""
    key = jax.random.PRNGKey(0)
    ref = jsamp.sample_depth(key, (2, 5), 16, DEPTH, stratified=stratified, param=param)
    rand = torch.from_numpy(np.array(jax.random.uniform(key, (2, 5, 16, 1)))) if stratified else None
    out = tsamp.sample_depth(rand, (2, 5), 16, DEPTH, param=param)
    assert out.shape == (2, 5, 16, 1)
    _close(out, ref, rtol=1e-6, atol=0)


def test_sample_depth_from_pdf_matches_jax():
    """Inverse-CDF fine depths from a pdf with zero bins, a one-bin spike and
    a uniform row (searchsorted right=True, as side='right'); rtol 1e-5,
    atol 1e-5 of depths in [1.5, 4.5]."""
    rng = np.random.default_rng(1)
    pdf = rng.uniform(0, 1, (3, 4, 12)).astype(np.float32)
    pdf[0, :, 3:9] = 0.0
    pdf[1, 0] = 0.0
    pdf[1, 0, 5] = 1.0
    pdf[2, 1] = 1.0 / 12
    ref = jsamp.sample_depth_from_pdf(jnp.asarray(pdf), 10, DEPTH)
    out = tsamp.sample_depth_from_pdf(torch.from_numpy(pdf), 10, DEPTH)
    assert out.shape == (3, 4, 10, 1)
    _close(out, ref)


@pytest.mark.parametrize("random_u", [False, True])
def test_sample_pdf_matches_jax(random_u):
    """Hierarchical sampling over sorted bin edges, at midpoints or at the
    JAX-drawn uniforms (rtol 1e-5, atol 1e-5)."""
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0, 5, (4, 9)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (4, 8)).astype(np.float32)
    weights[1, 2:6] = 0.0
    key = jax.random.PRNGKey(3) if random_u else None
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 11, key=key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (4, 11)))) if random_u else None
    out = tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 11, u=u)
    _close(out, ref)


def _nets(seed):
    jm = jmlp.NeRFMLP(**ARCH)
    pts = jnp.zeros((1, 1, 3))
    params = jm.init(jax.random.PRNGKey(seed), pts, pts)
    tm = tmlp.NeRFMLP(**ARCH)
    nerf_params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _rays(B=2, R=6, seed=4):
    rng = np.random.default_rng(seed)
    center = np.broadcast_to(rng.standard_normal((B, 1, 3)) * 0.2 + [0, 0, -3.0],
                             (B, R, 3)).astype(np.float32)
    ray = (rng.standard_normal((B, R, 3)) * 0.3 + [0, 0, 1.0]).astype(np.float32)
    return center, ray


@pytest.mark.parametrize("fine", [False, True])
def test_render_rays_matches_jax(fine):
    """render_rays_mlp (tile=False on the JAX side) with the JAX-drawn
    stratified jitter and a background colour: rgb, depth, opacity and prob,
    coarse and coarse -> fine (16 + 12 samples); then the gradient of a loss
    on the rgb for every parameter of both networks, which reaches the
    coarse network in the fine case only through the inverse-CDF depths
    (outputs rtol 1e-5, atol 1e-5; gradients 1e-4 of each tensor's
    scale)."""
    jc, pc, tc = _nets(0)
    jf, pf, tf = _nets(1)
    center, ray = _rays()
    key = jax.random.PRNGKey(5)
    rand = np.array(jax.random.uniform(key, (2, 6, 16, 1)))
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    w = np.random.default_rng(6).standard_normal((2, 6, 3)).astype(np.float32)
    n_fine = 12 if fine else 0

    def jloss(p_c, p_f):
        out = jrender.render_rays_mlp(
            lambda x, d: jc.apply(p_c, x, d), jnp.asarray(center), jnp.asarray(ray), key, 16,
            DEPTH, bg_color=jnp.asarray(bg), tile=False,
            fine_apply_fn=(lambda x, d: jf.apply(p_f, x, d)) if fine else None,
            n_samples_fine=n_fine)
        return (out.rgb * w).sum(), out

    (_, out_j), (gc_j, gf_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        pc, pf)
    out_t = trender.render_rays_mlp(tc, torch.from_numpy(center), torch.from_numpy(ray),
                                    torch.from_numpy(rand), 16, DEPTH,
                                    bg_color=torch.from_numpy(bg),
                                    fine_apply_fn=tf if fine else None, n_samples_fine=n_fine)
    assert out_t.prob.shape == (2, 6, 16 + n_fine, 1)
    for a, b in zip(out_t, out_j):
        _close(a, b)
    params = tc.param_list() + tf.param_list()
    grads = torch.autograd.grad((out_t.rgb * torch.from_numpy(w)).sum(), params,
                                allow_unused=True)
    ref = ([gc_j["params"][l][k] for l, k in tc.leaf_names()]
           + [gf_j["params"][l][k] for l, k in tf.leaf_names()])
    for g, b in zip(grads, ref):
        b = np.asarray(b)
        if g is None:  # the fine network of a coarse render; the coarse rgb layers
            assert not b.any()
            continue
        np.testing.assert_allclose(g.numpy(), b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-12))
    if fine:  # the coarse network learns from the fine loss through the pdf
        assert max(float(g.abs().max()) for g in grads[:len(tc.param_list())]
                   if g is not None) > 0


def test_render_image_matches_jax():
    """render_image_mlp: a 7 x 9 image in chunks of 16 rays (the last one
    short) at bin midpoints, coarse -> fine, against the JAX chunked render
    (rtol 1e-5, atol 1e-5)."""
    jc, pc, tc = _nets(2)
    jf, pf, tf = _nets(3)
    pose = np.array([[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 3.0]], np.float32)
    intr = np.array([[8.0, 0, 4.5], [0, 8.0, 3.5], [0, 0, 1]], np.float32)
    rgb_j, depth_j = jrender.render_image_mlp(
        lambda x, d: jc.apply(pc, x, d), jnp.asarray(pose), jnp.asarray(intr), 7, 9, 16, DEPTH,
        chunk=16, fine_apply_fn=lambda x, d: jf.apply(pf, x, d), n_samples_fine=8)
    with torch.no_grad():
        rgb_t, depth_t = trender.render_image_mlp(tc, torch.from_numpy(pose),
                                                  torch.from_numpy(intr), 7, 9, 16, DEPTH,
                                                  chunk=16, fine_apply_fn=tf, n_samples_fine=8)
    assert rgb_t.shape == (7, 9, 3) and depth_t.shape == (7, 9)
    _close(rgb_t, rgb_j)
    _close(depth_t, depth_j)
