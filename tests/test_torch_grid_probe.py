"""The gather / scatter-add probes' plain versions (ops/cuda/grid_probe.py)
against numpy, as the TPU probe scripts check their kernels
(scripts/probe_r2d_chunked.py: numpy row indexing and np.add.at), and the
probe entry point's refusal without a GPU. The scripts run their kernels
on a TPU when imported, so they are not imported here."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import grid_probe as gp

torch.set_num_threads(1)
REPO = str(Path(__file__).resolve().parents[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1000, 1 << 14])
def test_gather_rows_plain_matches_numpy(dtype, n):
    rng = np.random.default_rng(n)
    tab = rng.standard_normal((4096, 256)).astype(np.float32)
    idx = rng.integers(0, 4096, n).astype(np.int32)
    t = torch.from_numpy(tab).to(dtype)
    before = gp.gather_rows.launches
    out = gp.gather_rows(t, torch.from_numpy(idx))
    assert gp.gather_rows.launches == before  # the CPU runs the plain version
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.take(t.float().numpy(), idx, axis=0))


@pytest.mark.parametrize("shape", [(8, 128), (2048, 128)])
def test_gather_lanes_plain_matches_numpy(shape):
    rng = np.random.default_rng(1)
    tab = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, shape[1], shape).astype(np.int32)
    out = gp.gather_lanes(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.take_along_axis(tab, idx, axis=1))


@pytest.mark.parametrize("n", [1, 1000, 1 << 12])
def test_scatter_add_rows_plain_matches_numpy(n):
    """index_add_ against np.add.at, both in f32 (the same additions in
    another order: 1e-5 of the scale)."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 512, n).astype(np.int32)
    val = rng.standard_normal((n, 256)).astype(np.float32)
    out = gp.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(val), 512)
    ref = np.zeros((512, 256), np.float32)
    np.add.at(ref, idx, val)
    assert out.shape == (512, 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kb", [1, 16, 227, 228])
def test_smem_scratch_plain(kb):
    """The plain version has no shared-memory limit: any whole number of
    128-float rows gives 2.0."""
    assert gp.smem_scratch(kb * 1024, "cpu").item() == 2.0


def test_probe_wrappers_refuse_other_devices_and_sizes():
    with pytest.raises(ValueError, match="multiple of 512"):
        gp.smem_scratch(1000)
    with pytest.raises(ValueError, match="unsupported device"):
        gp.smem_scratch(1024, "meta")
    tab = torch.zeros((8, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gp.gather_rows(tab, torch.zeros(3, dtype=torch.int32, device="meta"))


def test_probe_cli_refuses_without_a_gpu():
    """The probe entry point prints no probe and exits non-zero where CUDA
    is not available."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "-m", "myc_nerfs_tpu_torch.cli.probe_grid"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
