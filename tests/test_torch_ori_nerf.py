"""Port parity of OriginNeRF: freq_encode, OriginNeRFModel's plain path
(f32, bf16, remat) and density_raw, the fused path against the JAX
_apply_fused with the Pallas kernel in interpret mode (outputs and
gradients), the JAX params tree through core/bridge.py, the registry
entries, NGPTrainer's ``model=`` override against the JAX trainer, and
run_net training configs/nerf/demo_synthetic.py on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myc_nerfs_tpu.models import ori_nerf as jon
from myc_nerfs_tpu.render import ngp_render as jnr
from myc_nerfs_tpu.render import occupancy as jocc
from myc_nerfs_tpu.train import ngp_trainer as jtr
from myc_nerfs_tpu_torch.core import bridge
from myc_nerfs_tpu_torch.models import ori_nerf as ton
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.render import occupancy as tocc
from myc_nerfs_tpu_torch.train import ngp_trainer as ttr

torch.set_num_threads(1)

SMALL = dict(D=3, W=32, skips=(1,), multires_pos=4, multires_dir=2)
FUSED = dict(D=2, W=32, skips=(), multires_pos=2, multires_dir=2)  # widths [16, 33, 33]


def _inputs(n=64, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _pair(kw, seed=0, **extra):
    """A JAX model with its params and the port's model holding them."""
    jm = jon.OriginNeRFModel(jon.OriginNeRFConfig(**kw, **extra))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ton.OriginNeRFModel(ton.OriginNeRFConfig(**kw, **extra), device="cpu")
    bridge.load_ori_nerf_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("multires", [0, 1, 4, 10])
def test_freq_encode_matches_jax(multires):
    """rtol 1e-6: the same sin/cos of the same f32 products."""
    x, _ = _inputs(37)
    ref = jon.freq_encode(jnp.asarray(x), multires)
    out = ton.freq_encode(torch.from_numpy(x), multires)
    assert out.shape == (37, ton.encoded_dim(multires))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_layer_shapes_and_leaf_order_match_the_jax_tree():
    jm, params, tm = _pair(SMALL)
    leaves = jax.tree_util.tree_leaves(params)
    mine = tm.param_list()
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, skips=(2,)), FUSED],
                         ids=["skip1", "skip_last", "no_skip"])
def test_f32_apply_and_density_match_jax(kw):
    """f32 forward (rgb and density raw) and density_raw, 1e-5 of scale."""
    jm, params, tm = _pair(kw)
    x, d = _inputs()
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(d)))
    out = tm(torch.from_numpy(x), torch.from_numpy(d))
    assert out.dtype == torch.float32 and out.shape == (64, 4)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    dref = np.asarray(jm.density_raw(params, jnp.asarray(x)))
    dout = tm.density_raw(torch.from_numpy(x))
    np.testing.assert_allclose(dout.detach().numpy(), dref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dout.detach().numpy(), out[:, 3:].detach().numpy(), atol=1e-6)


def test_bf16_apply_matches_jax():
    """bf16 params and compute, as flax Dense(dtype=bf16): every layer
    rounds its product and its bias sum to bf16. XLA may sum a dot in
    another order or fuse the bias add, so a rounding can land one bf16
    ulp apart and carry through the later layers: 4 ulps (2^-6) of each
    output's scale."""
    jm, params, tm = _pair(SMALL, use_bf16=True)
    assert all(p.dtype == torch.bfloat16 for p in tm.param_list())
    x, d = _inputs(256)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(d)))
    out = tm(torch.from_numpy(x), torch.from_numpy(d)).detach().numpy()
    scale = np.abs(ref).max(axis=0)
    assert (np.abs(out - ref) <= 2.0 ** -6 * np.maximum(scale, 1.0)).all()
    dref = np.asarray(jm.density_raw(params, jnp.asarray(x)))
    dout = tm.density_raw(torch.from_numpy(x)).detach().numpy()
    assert (np.abs(dout - dref) <= 2.0 ** -6 * max(np.abs(dref).max(), 1.0)).all()


@pytest.mark.parametrize("fused", [False, True])
def test_remat_is_equal_to_no_remat(fused):
    """torch.utils.checkpoint recomputes the same operations: outputs and
    every gradient bit for bit."""
    kw = dict(FUSED, use_fused=fused)
    results = []
    for remat in (False, True):
        _, _, tm = _pair(kw, remat=remat)
        x, d = _inputs()
        out = tm(torch.from_numpy(x), torch.from_numpy(d))
        grads = torch.autograd.grad((out ** 2).sum(), tm.param_list())
        results.append([out] + list(grads))
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_path_matches_jax_interpret(bf16):
    """use_fused at D=2, W=32, skips=(): the backbone [16, 33, 33] through
    fused_mlp (here its plain versions; the card pads it to 48) against the
    JAX _apply_fused with the Pallas kernel in interpret mode, and the
    gradient of every parameter (torch autograd through the plain backward
    vs jax.grad). f32: 1e-5 of scale (sums in another order). bf16: the
    kernel output is rounded to bf16 per layer on both sides; 4 ulps
    (2^-6) of scale for outputs and gradients (one rounding that lands
    apart carries on)."""
    jm, params, tm = _pair(FUSED, use_bf16=bf16, use_fused=True)
    x, d = _inputs(96)
    w = np.random.default_rng(5).standard_normal((96, 4)).astype(np.float32)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(d))
        return (out * w).sum(), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x), torch.from_numpy(d))
    tgrads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tm.param_list())
    tol = 2.0 ** -6 if bf16 else 1e-5
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= tol * max(np.abs(ref).max(), 1.0)
    for name, a, b in zip(tm.leaf_names(), tgrads, jax.tree_util.tree_leaves(jgrads)):
        a, b = a.float().numpy(), _f32(b)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-3), name


def test_fused_heads_run_in_f32_and_the_plain_ones_in_bf16():
    """With bf16 params the fused path's heads promote to f32 (JAX
    v @ kernel + bias with an f32 v) and the plain path's stay bf16, so
    the two differ by more than the kernel's rounding; each matches its
    own JAX counterpart (the test above and test_bf16_apply_matches_jax)."""
    _, _, plain = _pair(FUSED, use_bf16=True)
    _, _, fused = _pair(FUSED, use_bf16=True, use_fused=True)
    x, d = _inputs(256)
    a = plain(torch.from_numpy(x), torch.from_numpy(d))
    b = fused(torch.from_numpy(x), torch.from_numpy(d))
    assert not torch.equal(a, b)
    # heads in f32: the rgb head's output is not on the bf16 grid
    assert not torch.equal(b, b.to(torch.bfloat16).float())



def test_the_mlp_seam_takes_the_plain_versions():
    """model.mlp = fused_mlp_plain routes the fused backbone through the
    plain versions under autograd (on the CPU the same bits as fused_mlp,
    the default); the plain backbone does not use the seam."""
    from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

    _, _, tm = _pair(FUSED, use_bf16=True, use_fused=True)
    assert tm.mlp is fm.fused_mlp
    x, d = (torch.from_numpy(a) for a in _inputs())
    results = []
    for mlp in (fm.fused_mlp, fm.fused_mlp_plain):
        tm.mlp = mlp
        out = tm(x, d)
        results.append([out] + list(torch.autograd.grad((out ** 2).sum(), tm.param_list())))
    for a, b in zip(*results):
        assert torch.equal(a, b)

def test_fused_density_raw_takes_the_plain_backbone():
    jm, params, tm = _pair(FUSED, use_fused=True)
    x, _ = _inputs()
    ref = np.asarray(jm.density_raw(params, jnp.asarray(x)))
    np.testing.assert_allclose(tm.density_raw(torch.from_numpy(x)).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_bridge_round_trip_and_refuses_the_other_family():
    _, params, tm = _pair(SMALL, use_bf16=True)
    back = bridge.ori_nerf_params_to_numpy(tm)
    ref = jax.tree_util.tree_map(_f32, params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bridge.param_leaves(tm, {"table": [], "mlp": {"params": {}}})


def test_registry_entries_match_jax():
    from myc_nerfs_tpu.core import components as jc  # noqa: F401
    from myc_nerfs_tpu.core.registry import ENCODERS as JE, LOSSES as JL, NETWORKS as JN
    from myc_nerfs_tpu_torch.core import components as tc  # noqa: F401
    from myc_nerfs_tpu_torch.core.registry import ENCODERS, LOSSES, NETWORKS

    for reg, jreg, name, kw in ((ENCODERS, JE, "FrequencyEncoder", {"multires": 7}),
                                (ENCODERS, JE, "FrequencyEncoder", {})):
        assert reg.get(name)(**kw) == jreg.get(name)(**kw)
    for kw in ({}, dict(D=4, W=64, skips=[2], use_bf16=True,
                        grid={"multires": 6}, dir_encoder={"multires": 3})):
        a, b = NETWORKS.get("OriginNeRFNetworks")(**kw), JN.get("OriginNeRFNetworks")(**kw)
        assert (a.D, a.W, a.skips, a.multires_pos, a.multires_dir, a.use_bf16, a.use_fused) == \
            (b.D, b.W, b.skips, b.multires_pos, b.multires_dir, b.use_bf16, b.use_fused)
    x = np.linspace(0, 1, 12, dtype=np.float32).reshape(4, 3)
    y = x[::-1].copy()
    np.testing.assert_allclose(
        LOSSES.get("MSELoss")()(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(JL.get("MSELoss")()(jnp.asarray(x), jnp.asarray(y))), rtol=1e-7)


G = 32


def _trainers(fused):
    """A JAX and a port trainer around the same OriginNeRF params (the
    ``model=`` override), the same occupancy grid, fresh Adam states."""
    kw = dict(FUSED, use_fused=fused)
    jm, params, tm = _pair(kw)
    rkw = dict(n_coarse=64, n_samples=16, n_compact=8, near_distance=0.05)
    tkw = dict(lr=1e-3, n_grid_uniform=64, n_grid_nonuniform=64)
    jt = jtr.NGPTrainer(None, jnr.NGPRenderConfig(**rkw), jtr.NGPTrainConfig(**tkw),
                        jax.random.PRNGKey(0), model=jm)
    tt = ttr.NGPTrainer(None, tnr.NGPRenderConfig(**rkw), ttr.NGPTrainConfig(**tkw),
                        torch.Generator().manual_seed(0), device="cpu", model=tm)
    jt.state = jt.state._replace(params=params, opt_state=jt.tx.init(params))
    okw = dict(grid_size=G, n_cascades=3, max_cascade=0)
    jt.occ_cfg, tt.occ_cfg = jocc.OccupancyConfig(**okw), tocc.OccupancyConfig(**okw)
    u = np.random.default_rng(0).uniform(0, 1, (3, G, G, G)).astype(np.float32)
    grid = np.where(u > 0.5, 0.08 * u, 0.0).astype(np.float32)
    bits, mean = jocc.update_bitfield(jt.occ_cfg, jnp.asarray(grid))
    occ = jocc.OccupancyState(density_grid=jnp.asarray(grid), bitfield=bits,
                              mean_density=mean, ema_step=jnp.zeros((), jnp.int32))
    jt.state = jt.state._replace(occ=occ)
    jt._step_fn = jt._build_step()
    tt.state = tt.state._replace(occ=bridge.occupancy_from_numpy(
        jax.tree_util.tree_map(np.asarray, occ._asdict())))
    return jt, tt


@pytest.mark.parametrize("fused", [False, True])
def test_train_steps_with_model_override_match_jax(fused):
    """Three f32 steps of the port's NGPTrainer(model=OriginNeRFModel)
    against the JAX trainer's _step_fn on the same rays, targets,
    backgrounds and march jitter (the fused path under the Pallas kernel in
    interpret mode). Loss rtol 1e-5; params after each step within 1e-6 of
    their scale plus 1e-3 of the learning rate (Adam divides by the
    gradient's own scale, so a rounding in a small gradient moves the step
    by a part of lr)."""
    jt, tt = _trainers(fused)
    rng = np.random.default_rng(1)
    N = 128
    for k in range(3):
        o = rng.standard_normal((N, 3))
        o = 0.5 + o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.2
        d = rng.uniform(0, 1, (N, 3)) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
        tgt = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        bg = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        key = jax.random.PRNGKey(10 + k)
        xi = np.array(jax.random.uniform(key, (N, 1)))
        with pltpu.force_tpu_interpret_mode():
            jt.state, jmet = jt._step_fn(jt.state, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tgt), jnp.asarray(bg), key)
        tmet = tt.train_block(o[None], d[None], tgt[None], bg=bg[None], xi=xi[None])
        np.testing.assert_allclose(float(tmet["loss"][0]), float(jmet["loss"]), rtol=1e-5)
        assert int(tmet["n_samples"][0]) == int(jmet["n_samples"]) > N
        for a, b in zip(tt.model.param_list(), jax.tree_util.tree_leaves(jt.state.params)):
            a, b = a.detach().numpy(), np.asarray(b)
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0) + 1e-3 * tt.cfg.lr


def test_run_net_trains_nerf_demo_and_jax_restores_it(tmp_path):
    """run_net --device cpu on configs/nerf/demo_synthetic.py (OriginNeRF,
    skips (4,), f32) for 32 steps: the train PSNR is finite, model.ckpt is
    written, the JAX restore_checkpoint reads it into a JAX trainer with
    the same params, and the port restores it bit for bit."""
    from myc_nerfs_tpu.core.checkpoint import restore_checkpoint as jrestore
    from myc_nerfs_tpu.models.ori_nerf import OriginNeRFModel as JM
    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.checkpoint import restore_checkpoint
    from myc_nerfs_tpu_torch.core.config import load_config

    out = run_net.main(["--config-file", "configs/nerf/demo_synthetic.py", "--task", "train",
                        "--steps", "32", "--save_dir", str(tmp_path), "--device", "cpu"])
    ckpt = os.path.join(out, "model.ckpt")
    assert os.path.exists(ckpt)
    cfg = load_config("configs/nerf/demo_synthetic.py")
    cfg["synthetic"] = True
    trainer, _ = run_net.build_trainer(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert isinstance(trainer.model, ton.OriginNeRFModel) and trainer.model.cfg.skips == (4,)
    before = [p.detach().clone() for p in trainer.model.param_list()]
    trainer.state, meta = restore_checkpoint(ckpt, trainer.state)
    assert meta["step"] == 32 and trainer.state.step == 32
    assert not all(torch.equal(a, b) for a, b in zip(before, trainer.model.param_list()))
    jm = JM(jon.OriginNeRFConfig(D=8, W=256, skips=(4,)))
    jt = jtr.NGPTrainer(None, jnr.NGPRenderConfig(n_coarse=16, n_samples=8),
                        jtr.NGPTrainConfig(), jax.random.PRNGKey(0), model=jm)
    jstate, _ = jrestore(ckpt, jt.state)
    assert int(jstate.step) == 32
    for a, b in zip(trainer.model.param_list(), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
