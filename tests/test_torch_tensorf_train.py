"""Port parity of the TensoRF trainer against the JAX package: the
learning-rate schedule, the voxel schedule and the parameter groups; three
train steps of each family (VM-split, VM, CP, REFTensoRF, NerfPlusPlus),
each from the JAX state of that step (a JAX state loaded into the port):
mse, every gradient, both Adams' moments and counts, and the params; and a
staged run of configs/tensorf/demo_synthetic.txt through both trainers on
the same rays and draws, whose stage geometry must agree at every event
(both Adams restarting at count 0 after each)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from myc_nerfs_tpu.cli import tensorf_train as jcli
from myc_nerfs_tpu.train import tensorf_trainer as jtt
from myc_nerfs_tpu_torch.cli import tensorf_train as tcli
from myc_nerfs_tpu_torch.core.bridge import (load_tensorf_params, tensorf_adam_from_numpy,
                                             tensorf_params_tree, tree_get)
from myc_nerfs_tpu_torch.models import tensorf as ttf
from myc_nerfs_tpu_torch.train import tensorf_trainer as ttt

torch.set_num_threads(1)

AABB = np.asarray([[-1.2, -1.1, -1.0], [1.2, 1.0, 1.1]], np.float32)
# gradients: f32 sums over the batch in another order; each tensor within
# 1e-4 of its largest element. Params after Adam: the port's update of its
# own gradients equals optax's update of them (1e-6 absolute, params are
# O(1)); against the JAX step's params within 1e-4 of the learning rate
# wherever the gradient is at least 1e-2 of its tensor's largest: the
# update lr * m / (sqrt(v) + eps) turns a rounding of a gradient near 0
# into a step of up to lr
GRAD_TOL, STEP_TOL, SIGNIFICANT = 1e-4, 1e-4, 1e-2


def _jax_cfg(model_cfg):
    return model_cfg.__class__(**{**model_cfg.__dict__, "density_sample_budget": 0,
                                  "app_sample_budget": 0, "density_batch_budget": 0,
                                  "factor_gather_bf16": False})


def _config(model_name, **kw):
    """The parsed-config dict of a small run of ``model_name``: 10-11 voxels
    a side, density_shift -1, TV / L1 / ortho on, L1 switching at step 6."""
    a = dict(model_name=model_name, n_lamb_sigma=[3, 4, 5], n_lamb_sh=[6, 5, 4],
             data_dim_color=9, featureC=16, view_pe=2, fea_pe=2, density_shift=-1.0,
             rm_weight_mask_thre=1e-3, near=1.0, far=5.0, N_voxel_init=1320,
             N_voxel_final=4000, n_iters=100, batch_size=48, upsamp_list=[50],
             update_AlphaMask_list=[6, 60], TV_weight_density=0.3, TV_weight_app=0.2,
             L1_weight_inital=8e-5, L1_weight_rest=4e-5, Ortho_weight=1e-3,
             normal_vector_penalty_weight=0.5, bg_freq=2, bg_view_freq=2, bg_D=3, radii=3.0,
             bg_samples=16, white_bkgd=True)
    if model_name in ("TensorVM", "TensorCP"):
        a.update(n_lamb_sigma=[4], n_lamb_sh=[6])
    if model_name == "TensorCP":
        a.update(TV_weight_density=0.0, TV_weight_app=0.0)  # CP's TV is NaN in both
    a.update(kw)
    return a


def _trainers(a, scale=8.0):
    """The JAX trainer (its factor grids scaled up so density and appearance
    vary) and the port's holding the same params."""
    model_cfg, train_cfg = jcli.build_configs(a)
    jtr = jcli.build_family_trainer(a, _jax_cfg(model_cfg), train_cfg, AABB,
                                    jax.random.PRNGKey(0))
    for k in list(jtr.params):
        if k.endswith(("_plane", "_line")):
            jtr.params[k] = tuple(scale * v for v in jtr.params[k])
    tm, tcfg = tcli.build_configs(a)
    ttr = tcli.build_family_trainer(a, tm, tcfg, AABB, torch.Generator().manual_seed(0), "cpu")
    ttr.params = load_tensorf_params(ttr.params, jax.tree_util.tree_map(np.asarray, jtr.params))
    ttr._rebuild(1.0)
    return jtr, ttr


def _draws(model_name, key, n_rays, n_samples, bg_samples):
    """The JAX step's draws for ``key``, as the forward makes them."""
    if model_name == "NerfPlusPlus":
        k_fg, k_bg = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.uniform(k_fg, (n_rays, n_samples)))),
                torch.from_numpy(np.array(jax.random.uniform(k_bg, (n_rays, bg_samples)))))
    return torch.from_numpy(np.array(jax.random.uniform(key, (n_rays, 1))))


def _nest(paths, tensors):
    """A state dict (lists keyed "0", "1", ...) of tensors at paths, as numpy."""
    tree = {}
    for path, t in zip(paths, tensors):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.numpy()
    return tree


def _rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(float(np.abs(b).max()), 1e-30))


def _load_jax_state(ttr, jparams, jopt, step):
    ttr.params = load_tensorf_params(ttr.params, jax.tree_util.tree_map(np.asarray, jparams))
    ttr.opt_spatial, ttr.opt_net = tensorf_adam_from_numpy(
        ttr.params, jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jopt)))
    ttr.set_step(step)


def test_schedules_and_groups_match_jax():
    """decay_schedule against the JAX optimizer's learning rate (the update
    of a unit gradient from a fresh state at each count), n_to_reso and
    n_voxel_schedule."""
    cfg = ttt.TensoRFTrainConfig(n_iters=1000)
    jcfg = jtt.TensoRFTrainConfig(n_iters=1000)
    lr_factor = ttt.lr_factor_of(cfg)
    for lr_scale in (1.0, 0.37):
        tx, jf = jtt.make_optimizer(jcfg, {"basis_mat": jnp.zeros(()), "x": jnp.zeros(())},
                                    lr_scale)
        assert jf == lr_factor
        sched = ttt.decay_schedule(cfg.lr_basis * lr_scale, lr_factor)
        for c in (0, 1, 7, 500, 999, 4000):
            st = tx.init({"basis_mat": jnp.zeros(()), "x": jnp.zeros(())})
            inner = st.inner_states["net"].inner_state
            adam = inner[0]._replace(count=jnp.int32(c))
            if c:
                adam = adam._replace(mu={**adam.mu, "basis_mat": jnp.float32(1 - 0.9 ** c)},
                                     nu={**adam.nu, "basis_mat": jnp.float32(1 - 0.99 ** c)})
            st.inner_states["net"] = st.inner_states["net"]._replace(
                inner_state=(adam, inner[1]._replace(count=jnp.int32(c))))
            up, _ = tx.update({"basis_mat": jnp.ones(()), "x": jnp.ones(())}, st)
            np.testing.assert_allclose(float(sched(torch.tensor(c, dtype=torch.int32))),
                                       -float(up["basis_mat"]), rtol=2e-5)
    for n in (1320, 2097156, 27_000_000):
        assert ttt.n_to_reso(n, AABB) == jtt.n_to_reso(n, AABB)
    for ups in ((2000, 3000, 4000, 5500, 7000), (50,), ()):
        c = dict(n_voxel_init=2097156, n_voxel_final=27_000_000, upsamp_list=ups)
        assert ttt.n_voxel_schedule(ttt.TensoRFTrainConfig(**c)) == \
            jtt.n_voxel_schedule(jtt.TensoRFTrainConfig(**c))


FAMILIES = ["TensorVMSplit", "TensorVM", "TensorCP", "REFTensoRF", "NerfPlusPlus"]


@pytest.mark.parametrize("model_name", FAMILIES)
def test_train_steps_match_jax(model_name):
    """The spatial / net groups of _label_params; steps 4, 5 and 6 (the L1
    weight switches at 6), each from the JAX state of that step: mse and
    psnr (rtol 1e-5), every gradient and both Adams' moments (GRAD_TOL of
    each tensor's scale), the counts, and the params (see STEP_TOL)."""
    a = _config(model_name)
    jtr, ttr = _trainers(a)
    labels = jtt._label_params(jtr.params)
    spatial, net = ttf.param_groups(ttr.params)
    assert {p[0] for p in spatial} == {k for k, v in labels.items() if v == "spatial"}
    assert {p[0] for p in net} == {k for k, v in labels.items() if v == "net"}
    grad_tx = optax.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    args = (jtr.model_cfg, jtr.cfg, jtr.geom)
    rest = (jtr.buffers, jtr.lr_factor, jtr.extra_loss_fn, jtr.forward_fn)
    grad_core = jax.jit(jtt._make_step_core(*args, grad_tx, *rest))
    step_core = jax.jit(jtt._make_step_core(*args, jtr.tx, *rest))
    rng = np.random.default_rng(1)
    from test_torch_tensorf_model import make_rays

    jp, jopt = jtr.params, jtr.opt_state
    lr = {"spatial": jtr.cfg.lr_init, "net": jtr.cfg.lr_basis}
    for step in (4, 5, 6):
        rays = make_rays(48, seed=step, radius=2.0 if model_name == "NerfPlusPlus" else 3.2)
        rgbs = rng.uniform(0, 1, (48, 3)).astype(np.float32)
        key = jax.random.PRNGKey(10 + step)
        jargs = (jnp.asarray(rays), jnp.asarray(rgbs), key, jnp.int32(step))
        _, jgrads, _ = grad_core(jp, (), *jargs)
        jp2, jopt2, jm = step_core(jp, jopt, *jargs)

        _load_jax_state(ttr, jp, jopt, step)
        draws = _draws(model_name, key, 48, ttr.geom.n_samples, a["bg_samples"])
        g_s, g_n, _ = ttr.grads(torch.from_numpy(rays), torch.from_numpy(rgbs), draws)
        m = ttr.train_step(torch.from_numpy(rays), torch.from_numpy(rgbs), draws)
        np.testing.assert_allclose(float(m["mse"]), float(jm["mse"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["psnr"]), float(jm["psnr"]), rtol=1e-5)
        jg = jax.tree_util.tree_map(np.asarray, jgrads)
        paths_s, paths_n = ttf.param_groups(ttr.params)
        for path, g in zip(paths_s + paths_n, g_s + g_n):
            _rel_close(g.numpy(), tree_get(jg, path), GRAD_TOL)
        jstate = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jopt2))
        for name, opt, paths in (("spatial", ttr.opt_spatial, paths_s),
                                 ("net", ttr.opt_net, paths_n)):
            inner = jstate["inner_states"][name]["inner_state"]
            assert int(opt.count) == int(inner["0"]["count"]) == int(inner["1"]["count"])
            for mine, theirs in ((opt.mu, inner["0"]["mu"]), (opt.nu, inner["0"]["nu"])):
                for path, t in zip(paths, mine):
                    _rel_close(t.numpy(), tree_get(theirs, path), GRAD_TOL)
        # optax's update of the port's gradients, from the same JAX state
        port_g = serialization.from_state_dict(jp, _nest(paths_s + paths_n, g_s + g_n))
        updates, _ = jtr.tx.update(port_g, jopt, jp)
        expect = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jp, updates))
        tree = tensorf_params_tree(ttr.params)
        for name, paths in (("spatial", paths_s), ("net", paths_n)):
            for path in paths:
                np.testing.assert_allclose(tree_get(tree, path), tree_get(expect, path),
                                           rtol=0, atol=1e-6)
                sig = np.abs(tree_get(jg, path)) >= SIGNIFICANT * np.abs(tree_get(jg, path)).max()
                np.testing.assert_allclose(tree_get(tree, path)[sig],
                                           np.asarray(tree_get(jp2, path))[sig],
                                           rtol=0, atol=STEP_TOL * lr[name])
        assert ttr.global_step == step + 1
        jp, jopt = jp2, jopt2


def _jax_jitter(start, n_iters, events, n_rays):
    """Each step's jitter [n_rays, 1] of one JAX train() call from ``start``:
    the key PRNGKey(0) split per block of up to 16 steps that stop at events,
    split again per step (tensorf_trainer.py:226-249)."""
    key = jax.random.PRNGKey(0)
    end = start + n_iters
    stops = sorted(set(list(events) + [end]))
    out, it = {}, start
    while it < end:
        s = max(1, min(16, min(e for e in stops if e > it) - it, end - it))
        key, k = jax.random.split(key)
        for i, ki in enumerate(jax.random.split(k, s)):
            out[it + i] = torch.from_numpy(np.array(jax.random.uniform(ki, (n_rays, 1))))
        it += s
    return out


def _bump_density(jtr):
    """Density planes with a centred bump (lines at 1), so the alpha mask
    is a ball inside the box and the shrink cuts the grids."""
    p = dict(jtr.params)
    planes, lines = [], []
    for i, (pl, ln) in enumerate(zip(p["density_plane"], p["density_line"])):
        C, H, W = pl.shape
        v, u = jnp.meshgrid(jnp.linspace(-1, 1, H), jnp.linspace(-1, 1, W), indexing="ij")
        planes.append(pl + 0.4 * jnp.exp(-(u**2 + v**2) / 0.15)[None])
        lines.append(ln + jnp.exp(-jnp.linspace(-1, 1, ln.shape[1])**2 / 0.3)[None])
    p["density_plane"], p["density_line"] = tuple(planes), tuple(lines)
    jtr.params = p


def test_staged_demo_run_matches_jax():
    """configs/tensorf/demo_synthetic.txt's events divided by 50 (upsample
    at 4 and 8, the alpha mask at 6, with the shrink) plus a second mask
    update at 8 (the ray refilter, before that step's upsample), 10 steps
    on a 3-view 12^2 scene, threshold 0.2 on a centred density bump: both
    trainers on the same rays, ray ids and jitter, one train() call per
    segment. After every event the stage geometry (grid size, step,
    samples, units), the aabb and the alpha volume are equal and both Adams'
    counts are 0."""
    a = jcli.parse_txt_config("configs/tensorf/demo_synthetic.txt")
    a.update(synthetic_size=12, synthetic_views=3, batch_size=128, N_voxel_init=1728,
             N_voxel_final=8000, upsamp_list=[4, 8], update_AlphaMask_list=[6, 8],
             n_iters=10, alpha_mask_thre=0.2, density_shift=-1.0)
    rays, rgbs, aabb, _ = jcli.load_rays(a)
    jtr, ttr = _trainers({**a, "bbox": aabb.reshape(-1).tolist()}, scale=1.0)
    _bump_density(jtr)
    ttr.params = load_tensorf_params(ttr.params, jax.tree_util.tree_map(np.asarray, jtr.params))
    trays, trgbs = torch.from_numpy(np.array(rays)), torch.from_numpy(np.array(rgbs))
    events = a["upsamp_list"] + a["update_AlphaMask_list"]
    shrunk = False
    for stop in (4, 6, 8, 10):
        n = stop - jtr.global_step
        jitter = _jax_jitter(jtr.global_step, n, events, a["batch_size"])
        jtr.train(rays, rgbs, n_iters=n)
        ttr.train(trays, trgbs, n_iters=n, draws=lambda it: jitter[it])
        assert ttr.global_step == jtr.global_step == stop
        assert tuple(ttr.geom) == tuple(jtr.geom), stop
        np.testing.assert_array_equal(ttr.buffers["aabb"].numpy(), np.asarray(jtr.buffers["aabb"]))
        jvol = jtr.buffers.get("alpha_volume")
        tvol = ttr.buffers.get("alpha_volume")
        assert (jvol is None) == (tvol is None)
        if jvol is not None:
            np.testing.assert_array_equal(tvol.numpy(), np.asarray(jvol))
        shrunk = shrunk or tuple(ttr.geom.grid_size) != tuple(
            ttt.n_to_reso(ttt.n_voxel_schedule(ttr.cfg)[0], aabb))
        if stop in events:
            assert int(ttr.opt_spatial.count) == int(ttr.opt_net.count) == 0
            for name in ("spatial", "net"):
                inner = jtr.opt_state.inner_states[name].inner_state
                assert int(inner[0].count) == int(inner[1].count) == 0
    assert shrunk and float(ttr.buffers["aabb"][1, 0] - ttr.buffers["aabb"][0, 0]) < 2.4
