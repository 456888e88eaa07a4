"""The port's checkpoint codec (core/checkpoint.py): its msgpack bytes
against msgpack.packb's, on scalars at every encoding boundary and on the
port's NGP and OriginNeRF trainer states; a file the JAX save_checkpoint
wrote, read back exactly; and a save and restore with the msgpack package
unavailable."""
import sys

import jax
import msgpack
import numpy as np
import pytest
import torch

from myc_nerfs_tpu.core import checkpoint as jck
from myc_nerfs_tpu.models import ori_nerf as jon
from myc_nerfs_tpu.render import ngp_render as jnr
from myc_nerfs_tpu.train import ngp_trainer as jtr
from myc_nerfs_tpu_torch.core import checkpoint as ck
from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.models import ori_nerf as ton
from myc_nerfs_tpu_torch.render import ngp_render as tnr
from myc_nerfs_tpu_torch.train import ngp_trainer as ttr

torch.set_num_threads(1)

INTS = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x100000000,
        2 ** 64 - 1, -1, -0x20, -0x21, -0x80, -0x81, -0x8000, -0x8001, -0x80000000,
        -0x80000001, -2 ** 63]
SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _cases():
    cases = [("int", v) for v in INTS]
    cases += [("float", v) for v in (0.0, -1.5, 1e300, float("inf"))]
    cases += [("str", "k" * n) for n in SIZES] + [("str", "päßé")]
    cases += [("bin", bytes(range(256)) * (n // 256) + bytes(n % 256)) for n in SIZES]
    cases += [("list", list(range(n))) for n in (0, 15, 16, 70000)]
    cases += [("map", {str(i): i for i in range(n)}) for n in (0, 15, 16, 70000)]
    cases += [("ext", ck.ExtType(c, b"x" * n)) for c, n in ((1, 1), (3, 2), (1, 4), (1, 8),
                                                           (1, 16), (1, 3), (1, 300),
                                                           (1, 70000))]
    cases += [("nested", {"a": [None, True, False, {"b": b"\x00"}], "c": -3})]
    return cases


def _msgpack_obj(obj):
    """The same object with msgpack's own ExtType."""
    if isinstance(obj, ck.ExtType):
        return msgpack.ExtType(obj.code, obj.data)
    if isinstance(obj, dict):
        return {k: _msgpack_obj(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_msgpack_obj(v) for v in obj]
    return obj


@pytest.mark.parametrize("kind,obj", _cases(), ids=lambda v: v if isinstance(v, str)
                         and len(v) < 12 else None)
def test_codec_bytes_equal_msgpacks(kind, obj):
    data = ck.packb(obj)
    assert data == msgpack.packb(_msgpack_obj(obj), strict_types=True)
    back = ck.unpackb(data)
    assert back == obj or (kind == "ext" and back == (obj.code, obj.data))


def test_reader_takes_float32_and_rejects_truncated_data():
    assert ck.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError):
        ck.unpackb(msgpack.packb([1, 2, 3])[:-1])


DEMO_GRID = dict(n_levels=4, log2_hashmap_size=12, desired_resolution=64.0)


def _states():
    """A port NGP (bf16 MLP) and a port OriginNeRF trainer state after two
    steps, so the Adam moments are not zero."""
    rcfg = tnr.NGPRenderConfig(n_coarse=32, n_compact=8, near_distance=0.05)
    tcfg = ttr.NGPTrainConfig(n_grid_uniform=64, n_grid_nonuniform=64)
    gen = torch.Generator().manual_seed(0)
    ngp = ttr.NGPTrainer(tngp.NGPModelConfig(grid=tngp.HashGridConfig(**DEMO_GRID),
                                             use_bf16=True), rcfg, tcfg, gen, device="cpu")
    ori = ttr.NGPTrainer(None, rcfg, tcfg, gen, device="cpu", model=ton.OriginNeRFModel(
        ton.OriginNeRFConfig(D=3, W=32, skips=(1,), multires_pos=4, multires_dir=2),
        device="cpu", generator=gen))
    rng = np.random.default_rng(0)
    for t in (ngp, ori):
        t.state = t.state._replace(occ=t.grid_update(t.state.occ, gen))
        o = np.full((2, 64, 3), 0.5, np.float32) + rng.uniform(-0.2, 0.2, (2, 64, 3)).astype(np.float32)
        d = rng.standard_normal((2, 64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t.train_block(o, d, rng.uniform(0, 1, (2, 64, 3)).astype(np.float32), generator=gen)
    return {"ngp": ngp, "ori_nerf": ori}


STATES = _states()


def _msgpack_ext(t):
    return msgpack.ExtType(1, msgpack.packb(ck.tensor_payload(t), use_bin_type=True))


@pytest.mark.parametrize("name", list(STATES))
def test_state_bytes_equal_msgpacks_and_restore_bit_for_bit(name, tmp_path):
    trainer = STATES[name]
    tree = ck.state_tree(trainer.state)
    data = ck.packb(tree, default=ck._tensor_ext)
    assert data == msgpack.packb(tree, default=_msgpack_ext, strict_types=True)
    path = ck.save_checkpoint(str(tmp_path / "model.ckpt"), trainer.state, step=7)
    with open(path, "rb") as f:
        assert f.read() == data
    fresh = _fresh(name)
    state, meta = ck.restore_checkpoint(path, fresh.state)
    assert meta == {"step": 7} and state.step == trainer.state.step
    _assert_same_state(state, trainer.state)


def _fresh(name, bf16=False):
    gen = torch.Generator().manual_seed(9)
    rcfg, tcfg = tnr.NGPRenderConfig(), ttr.NGPTrainConfig()
    if name == "ngp":
        return ttr.NGPTrainer(tngp.NGPModelConfig(grid=tngp.HashGridConfig(**DEMO_GRID),
                                                  use_bf16=True), rcfg, tcfg, gen, device="cpu")
    return ttr.NGPTrainer(None, rcfg, tcfg, gen, device="cpu", model=ton.OriginNeRFModel(
        ton.OriginNeRFConfig(D=3, W=32, skips=(1,), multires_pos=4, multires_dir=2,
                             use_bf16=bf16), device="cpu"))


def _assert_same_state(a, b):
    for x, y in zip(a.params.param_list(), b.params.param_list()):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(a.opt_state.count) == int(b.opt_state.count)
    for xs, ys in ((a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(a.occ, b.occ):
        assert torch.equal(x, y)


def test_a_jax_written_checkpoint_reads_back_exactly(tmp_path):
    """The JAX save_checkpoint of a JAX OriginNeRF (bf16) trainer: the
    params, the Adam moments, the grid and the step read back equal to the
    JAX state's (bf16 widened to f32, exactly), and the port restores the
    file into its own trainer."""
    jm = jon.OriginNeRFModel(jon.OriginNeRFConfig(D=3, W=32, skips=(1,), multires_pos=4,
                                                  multires_dir=2, use_bf16=True))
    jt = jtr.NGPTrainer(None, jnr.NGPRenderConfig(), jtr.NGPTrainConfig(),
                        jax.random.PRNGKey(3), model=jm)
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(path, jt.state, step=5)
    tree = ck.read_msgpack_tree(path)

    def f32(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    for got, want in ((tree["params"], jt.state.params),
                      (tree["opt_state"]["0"]["mu"], jt.state.opt_state[0].mu),
                      (tree["occ"], jt.state.occ._asdict())):
        want = jax.tree_util.tree_map(f32, want)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert int(tree["step"]) == 0
    port = _fresh("ori_nerf", bf16=True)
    state, meta = ck.restore_checkpoint(path, port.state)
    assert state.step == 0 and meta["step"] == 5
    for a, b in zip(port.model.param_list(), jax.tree_util.tree_leaves(jt.state.params)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().detach().numpy(), f32(b))


def test_save_and_restore_without_the_msgpack_package(tmp_path, monkeypatch):
    """With msgpack unimportable (as on a machine that lacks it) the port
    still saves and restores, bit for bit."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401
    trainer = STATES["ori_nerf"]
    path = ck.save_checkpoint(str(tmp_path / "m.ckpt"), trainer.state, step=2)
    state, meta = ck.restore_checkpoint(path, _fresh("ori_nerf").state)
    assert meta["step"] == 2
    _assert_same_state(state, trainer.state)
