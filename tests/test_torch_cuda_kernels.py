"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc and skips without one. This
file imports no JAX, so on a machine without it run:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import fused_mlp as fm

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _net(widths, rows, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.standard_normal((widths[i], widths[i + 1]))
                            / np.sqrt(widths[i])).astype(np.float32))
          .to(device, dtype) for i in range(len(widths) - 1)]
    x = torch.from_numpy(rng.standard_normal((rows, widths[0]))
                         .astype(np.float32)).to(device, dtype)
    return x, ws


# f32: the same products summed in another order (1e-5 of the scale);
# bf16: every layer rounds to bf16, a sum on the other side of a rounding
# boundary moves an intermediate by one ulp (2 ulps, 2^-7, of the scale)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("widths", [(32, 64, 16), (32, 64, 64, 16),
                                    (16, 32, 48, 64, 16)])
@pytest.mark.parametrize("rows", [1, 63, 1000, 70001])
def test_fused_mlp_matches_plain(cuda_device, widths, dtype, rtol, rows):
    x, ws = _net(widths, rows, dtype, cuda_device)
    before = fm.fused_mlp.launches
    with torch.no_grad():
        out = fm.fused_mlp(x, ws)
        ref = fm.fused_mlp_reference(x, ws)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    assert out.dtype == dtype and out.shape == (rows, widths[-1])
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= rtol * scale


def test_fused_mlp_refuses_what_the_kernel_does_not_take(cuda_device):
    x, ws = _net((32, 64, 8), 10, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiples of 16"):
        fm.fused_mlp(x, ws)
    x, ws = _net((32, 64, 16), 10, torch.float16, cuda_device)
    with pytest.raises(TypeError):
        fm.fused_mlp(x, ws)
    x, ws = _net((32, 16), 10, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="device and dtype"):
        fm.fused_mlp(x, [ws[0].cpu()])
    with pytest.raises(RuntimeError, match="forward-only"):
        fm.fused_mlp(x.requires_grad_(), ws)


def test_ngp_model_on_gpu_matches_cpu(cuda_device):
    """The NGP model with its MLPs through the kernel on the card against
    the same weights on the CPU through the plain version (f32; the encode
    and SH run as torch ops on both)."""
    from myc_nerfs_tpu_torch.models import ngp

    cfg = ngp.NGPModelConfig(grid=ngp.HashGridConfig(
        n_levels=8, log2_hashmap_size=15, desired_resolution=256.0))
    cpu = ngp.NGPModel(cfg, generator=torch.Generator().manual_seed(0))
    gpu = ngp.NGPModel(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    before = fm.fused_mlp.launches
    with torch.no_grad():
        ref = cpu(pos, dirs)
        out = gpu(pos.to(cuda_device), dirs.to(cuda_device)).cpu()
    assert fm.fused_mlp.launches == before + 2  # density and rgb MLPs
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
