"""The NGP rgb-MLP input kernel (csrc/rgb_input.cu) on a GPU, against its
plain PyTorch version, ops/cuda/rgb_input.py::rgb_input_plain (the eager
composition [h | sh_encode(dirs * 2 - 1).to(h's dtype)]), on CUDA tensors.

Every test here needs an NVIDIA GPU and nvcc and skips without one. This
file imports no JAX, so on a machine without it run:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rgb_input.py

Exactness: the kernel rounds every product and difference as the plain
version's torch ops do, in their order, so x equals the plain version's bit
for bit, and so does a whole rendered frame. h's gradient is the slice of
g that the concatenation's backward gives; the directions' gradient goes
through the plain sh_encode under autograd (test-time pose optimisation),
so it equals the plain composition's to DIRS_GRAD_RTOL.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.models import ngp as tngp
from myc_nerfs_tpu_torch.ops.cuda import rgb_input as ri
from myc_nerfs_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

DIRS_GRAD_RTOL = 1e-6
ROWS = 262144                 # a render chunk: 4096 rays x 64 samples
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def launches() -> int:
    return profiling.counts(traced=False)["launch.rgb_input"]


def case(n: int, dtype, device, seed: int = 0):
    """h [n, 16] in dtype and dirs [n, 3] warped to [0, 1]: unit directions,
    every 7th row on the 0 and 1 borders, every 11th a padded zero ray's
    0.5 (the frame's last chunk)."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((n, 3), generator=g)
    d = (d / d.norm(dim=-1, keepdim=True) + 1.0) * 0.5
    d[::7] = torch.randint(0, 2, (d[::7].shape[0], 3), generator=g).float()
    d[::11] = 0.5
    h = torch.empty((n, 16)).uniform_(-4, 4, generator=g)
    return h.to(device, dtype), d.to(device)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def assert_bit_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    differing = int((bits(got) != bits(want)).sum())
    assert differing == 0, f"{differing} elements differ"


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("n", [ROWS, 4077 * 64, 1000, 1, 0])
def test_kernel_equals_plain(cuda, dtype, n):
    """Contiguous directions: at a render chunk's rows, at row counts that
    are no multiple of the 256-row block, and at no rows; one launch per
    call that has rows."""
    h, d = case(n, dtype, cuda, seed=n)
    profiling.reset()
    with torch.no_grad():
        got = ri.rgb_input(h, d)
    torch.cuda.synchronize()
    assert launches() == (1 if n else 0)
    assert_bit_equal(got, ri.rgb_input_plain(h, d))


def layouts(d: torch.Tensor) -> dict:
    """The same directions as views the kernel reads through their strides:
    a column slice of a wider tensor, a transpose, one ray's direction
    broadcast over every row (row stride 0), and the march's per-ray view
    expanded over the samples, as the field receives it."""
    n = d.shape[0]
    wide = torch.zeros((n, 5), device=d.device)
    wide[:, 1:4] = d
    k = 64
    per_ray = d[::k]
    return {"column_slice": wide[:, 1:4], "transposed": d.t().contiguous().t(),
            "broadcast": d[5].expand(n, 3),
            "march": per_ray[:, None, :].expand(per_ray.shape[0], k, 3).reshape(-1, 3)}


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("layout", ["column_slice", "transposed", "broadcast", "march"])
def test_kernel_reads_dirs_through_strides(cuda, dtype, layout):
    h, d = case(ROWS, dtype, cuda, seed=7)
    view = layouts(d)[layout]
    with torch.no_grad():
        got = ri.rgb_input(h, view)
    assert_bit_equal(got, ri.rgb_input_plain(h, view.contiguous()))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_kernel_takes_h_that_is_not_contiguous(cuda, dtype):
    h, d = case(4096, dtype, cuda, seed=3)
    wide = torch.cat([h, h], dim=-1)[:, 8:24]
    with torch.no_grad():
        assert_bit_equal(ri.rgb_input(wide, d), ri.rgb_input_plain(wide, d))


def grads(fn, h, d, g, dirs_grad: bool):
    hh = h.clone().requires_grad_()
    dd = d.clone().requires_grad_(dirs_grad)
    x = fn(hh, dd)
    leaves = [hh, dd] if dirs_grad else [hh]
    return x, torch.autograd.grad(x, leaves, g)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("dirs_grad", [False, True], ids=["h", "h_and_dirs"])
def test_gradients_equal_plain(cuda, dtype, dirs_grad):
    """h's gradient is g[:, :16] bit for bit, as the concatenation's
    backward gives it; the directions', where they require one, equals
    autograd through the plain composition to DIRS_GRAD_RTOL of its scale."""
    h, d = case(ROWS, dtype, cuda, seed=11)
    g = torch.empty((ROWS, 32), device=cuda).uniform_(-1, 1).to(dtype)
    profiling.reset()
    x_k, got = grads(ri.rgb_input, h, d, g, dirs_grad)
    x_p, want = grads(ri.rgb_input_plain, h, d, g, dirs_grad)
    torch.cuda.synchronize()
    assert launches() == 1
    assert_bit_equal(x_k, x_p)
    assert_bit_equal(got[0], want[0])
    assert_bit_equal(got[0], g[:, :16])
    if dirs_grad:
        err = (got[1] - want[1]).abs().max().item()
        assert err <= DIRS_GRAD_RTOL * want[1].abs().max().item(), err


def test_wrapper_raises(cuda):
    h, d = case(64, torch.bfloat16, cuda)
    for bad_h, bad_d, degree, kind in (
            (h.half(), d, 4, TypeError), (h, d.double(), 4, TypeError),
            (h[:, :8], d, 4, ValueError), (h, d[:32], 4, ValueError),
            (h, d, 3, ValueError), (h, d.cpu(), 4, ValueError)):
        with pytest.raises(kind):
            ri.rgb_input(bad_h, bad_d, degree)


def car_trainer(seed: int, use_bf16: bool):
    """The Car configuration's trainer with O(1) tables and an occupancy
    grid occupied at random, so that most chunks have valid samples."""
    import dataclasses

    from myc_nerfs_tpu_torch.cli import run_net
    from myc_nerfs_tpu_torch.core.config import load_config
    from myc_nerfs_tpu_torch.render import occupancy as occ

    cfg = load_config(str(REPO / "configs" / "ngp" / "Car.py"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    trainer, _ = run_net.build_trainer(cfg, gen, device="cuda")
    if not use_bf16:
        model = tngp.NGPModel(dataclasses.replace(trainer.model.cfg, use_bf16=False),
                              device="cuda", generator=gen)
        trainer.model = model
    with torch.no_grad():
        for t in trainer.model.tables:
            t.uniform_(-1, 1, generator=gen)
    c = trainer.occ_cfg
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((c.n_cascades, c.grid_size, c.grid_size, c.grid_size), generator=g)
    grid = torch.where(u > 0.7, 0.05 * u, 0.0).cuda()
    bitfield, mean = occ.update_bitfield(c, grid)
    trainer.state = trainer.state._replace(occ=trainer.state.occ._replace(
        density_grid=grid, bitfield=bitfield, mean_density=mean))
    return trainer


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
def test_render_frame_equals_plain_composition(cuda, use_bf16, monkeypatch):
    """A whole render_image frame (200 x 200: ten 4096-ray chunks, the last
    padded with zero rays) through the kernel equals the frame rendered with
    the eager composition in its place, bit for bit; one launch a chunk."""
    trainer = car_trainer(5, use_bf16)
    H = W = 200
    intr = torch.tensor([[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1.0]])
    c2w = torch.eye(4)
    c2w[:3, 3] = 0.5  # inside the box: every ray crosses the occupied grid
    profiling.reset()
    with torch.no_grad():
        rgb_k, depth_k = trainer.render_image(c2w, intr, H, W)
        torch.cuda.synchronize()
        n_launches = launches()
        monkeypatch.setattr(tngp, "rgb_input", ri.rgb_input_plain)
        rgb_p, depth_p = trainer.render_image(c2w, intr, H, W)
    assert n_launches == int(np.ceil(H * W / 4096))
    assert_bit_equal(rgb_k, rgb_p)
    assert_bit_equal(depth_k, depth_p)
    bg = torch.tensor(trainer.cfg.background_color, device="cuda")
    assert (rgb_k - bg).abs().max().item() > 1e-3, "the frame is all background"
