"""Port parity of the synthetic scenes (data/synthetic.py): the textured
and detail fields, make_scene(textured=), make_detail_scene (with and
without the outer torus) and make_cascade_scene against the JAX package's
at 16^2 with 32 samples per ray, and run_net building each scene kind."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.data import synthetic as jsyn
from myc_nerfs_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(1)


def _points(n=4096, seed=0, radius=2.5):
    return np.random.default_rng(seed).uniform(-radius, radius, (n, 3)).astype(np.float32)


# sin/cos of the same f32 arguments up to 181 rad and a sigmoid at slope
# 150: torch and XLA round their transcendental functions differently, up
# to a few f32 ulps of the argument; 1e-4 of the field's scale
@pytest.mark.parametrize("field", ["textured", "detail", "detail_outer"])
def test_fields_match_jax(field):
    p = _points()
    fn_j, fn_t = {
        "textured": (jsyn.analytic_field_textured, tsyn.analytic_field_textured),
        "detail": (jsyn.analytic_field_detail, tsyn.analytic_field_detail),
        "detail_outer": (lambda x: jsyn.analytic_field_detail(x, outer=True),
                         lambda x: tsyn.analytic_field_detail(x, outer=True))}[field]
    rgb_j, sig_j = fn_j(jnp.asarray(p))
    rgb_t, sig_t = fn_t(torch.from_numpy(p))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-4)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j),
                               atol=1e-4 * float(np.abs(np.asarray(sig_j)).max()))


def _compare(scene_t, scene_j):
    assert (scene_t.H, scene_t.W) == (scene_j.H, scene_j.W)
    assert tuple(scene_t.depth_range) == tuple(scene_j.depth_range)
    np.testing.assert_allclose(scene_t.poses.numpy(), np.asarray(scene_j.poses), atol=1e-6)
    np.testing.assert_allclose(scene_t.intr.numpy(), np.asarray(scene_j.intr), atol=1e-6)
    # the same quadrature of the same field; a pixel whose ray grazes the
    # detail sphere's surface (density 60 sigmoid(150 (r_s - r))) turns a
    # 1e-4 difference of one sample's density into more: 1e-3
    np.testing.assert_allclose(scene_t.images.numpy(), np.asarray(scene_j.images), atol=1e-3)
    assert scene_t.images.device.type == "cpu"


@pytest.mark.parametrize("outer", [False, True])
def test_detail_scene_matches_jax(outer):
    """6 views in three rings at 16^2, rendered in 8-row strips (the
    strip shift of the principal point), 32 samples per ray."""
    kw = dict(n_views=6, H=16, W=16, outer=outer, n_samples=32, chunk_rows=8)
    _compare(tsyn.make_detail_scene(**kw), jsyn.make_detail_scene(**kw))


def test_detail_scene_trims_a_ragged_last_strip():
    kw = dict(n_views=3, H=12, W=16, n_samples=32, chunk_rows=8)
    _compare(tsyn.make_detail_scene(**kw), jsyn.make_detail_scene(**kw))


def test_cascade_scene_matches_jax():
    kw = dict(n_views=8, H=16, W=16, n_samples=32, chunk_rows=16)
    _compare(tsyn.make_cascade_scene(**kw), jsyn.make_cascade_scene(**kw))
    with pytest.raises(ValueError):
        tsyn.make_cascade_scene(n_views=6, H=8, W=8, n_samples=8)


@pytest.mark.parametrize("textured", [False, True])
def test_make_scene_matches_jax(textured):
    kw = dict(n_views=6, H=16, W=16, textured=textured)
    _compare(tsyn.make_scene(**kw), jsyn.make_scene(**kw))


@pytest.mark.parametrize("kind", ["blobs", "detail", "cascade"])
def test_run_net_builds_each_scene_kind(kind):
    from myc_nerfs_tpu_torch.cli import run_net

    cfg = {"synthetic": True, "synthetic_scene": kind, "synthetic_size": 8,
           "synthetic_views": 6, "synthetic_val_views": 2}
    data, H, W = run_net.load_data(cfg, "cpu")
    assert (H, W) == (8, 8) and data.n_images == 6
    imgs, c2ws, _ = run_net.load_eval_views(cfg)
    assert imgs.shape == (2, 8, 8, 3) and len(c2ws) == 2
    with pytest.raises(ValueError):
        run_net.load_data({"synthetic": True, "synthetic_scene": "other"}, "cpu")
