"""Port parity: myc_nerfs_tpu_torch.ops.cuda.fused_mlp on the CPU against
the JAX Pallas fused_mlp (interpret mode, as tests/test_pallas_kernels.py
runs it). The CUDA kernel itself is tested in test_torch_cuda_kernels.py."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myc_nerfs_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(widths, seed, x_rows):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((widths[i], widths[i + 1])) / np.sqrt(widths[i]))
          .astype(np.float32) for i in range(len(widths) - 1)]
    x = rng.standard_normal((x_rows, widths[0])).astype(np.float32)
    return x, ws


def _jax(x, ws, dtype, tile):
    with pltpu.force_tpu_interpret_mode():
        out = jax_fused_mlp(jnp.asarray(x, dtype),
                            tuple(jnp.asarray(w, dtype) for w in ws), tile)
    return np.asarray(out.astype(jnp.float32))


def _torch(x, ws, dtype):
    out = fm.fused_mlp(torch.from_numpy(x).to(dtype),
                       [torch.from_numpy(w).to(dtype) for w in ws])
    assert out.dtype == dtype
    return out.float().numpy()


# rows that are not a multiple of the JAX tile (64) or of the kernel's
# 64-row tile
@pytest.mark.parametrize("widths,rows", [((32, 64, 64, 16), 300),
                                         ((16, 32, 8), 77)])
def test_f32_matches_jax(widths, rows):
    """f32: both sum the same products in f32, in another order (atol 1e-5
    on O(1) outputs)."""
    x, ws = _net(widths, 0, rows)
    np.testing.assert_allclose(_torch(x, ws, torch.float32),
                               _jax(x, ws, jnp.float32, 64), atol=1e-5)


@pytest.mark.parametrize("widths,rows", [((32, 64, 64, 16), 300),
                                         ((16, 32, 8), 77)])
def test_bf16_matches_jax(widths, rows):
    """bf16: products are exact in f32 and sums are f32 on both sides, then
    every layer rounds to bf16. A sum that lands on the other side of a
    rounding boundary moves an intermediate by one bf16 ulp, so allow two
    ulps (2^-7) of the output's scale."""
    x, ws = _net(widths, 1, rows)
    ref = _jax(x, ws, jnp.bfloat16, 64)
    out = _torch(x, ws, torch.bfloat16)
    assert np.abs(out - ref).max() <= 2.0 ** -7 * max(1.0, np.abs(ref).max())
    # and almost everywhere the two are bit-identical
    assert np.mean(out != ref) < 0.02


def test_rgb_head_column_padding():
    """The port runs the rgb head's width-3 last layer zero-padded to 16
    columns; the first 3 columns equal JAX's unpadded fused_mlp."""
    x, ws = _net((32, 64, 64, 3), 2, 130)
    ref = _jax(x, ws, jnp.float32, 64)
    ws_pad = ws[:-1] + [np.pad(ws[-1], ((0, 0), (0, 13)))]
    out = _torch(x, ws_pad, torch.float32)
    assert out.shape == (130, 16)
    np.testing.assert_allclose(out[:, :3], ref, atol=1e-5)
    np.testing.assert_array_equal(out[:, 3:], 0.0)


def test_wrapper_rejects_a_broken_chain():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, [torch.zeros(32, 64), torch.zeros(32, 16)])
    with pytest.raises(ValueError):
        fm.fused_mlp(torch.zeros(4, 2, 32), [torch.zeros(32, 16)])


def test_cpu_path_does_not_count_launches():
    before = fm.fused_mlp.launches
    x, ws = _net((16, 32, 16), 3, 10)
    _torch(x, ws, torch.float32)
    assert fm.fused_mlp.launches == before


def test_port_imports_no_jax():
    """Importing the whole port leaves jax out of sys.modules."""
    code = ("import sys, pkgutil, importlib, myc_nerfs_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import myc_nerfs_tpu_torch.cli.run_net\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'myc_nerfs_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=120)
