"""The NGP compositor kernels (csrc/composite.cu) on a GPU, against
render/ngp_render.py::composite_marched_plain (the eager composition, and
autograd through it) on CUDA tensors.

Every test here needs an NVIDIA GPU and nvcc and skips without one. This
file imports no JAX, so on a machine without it run:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_composite.py

Tolerances: the kernel sums the optical depth by a warp scan and reduces by
shuffles, torch in its own trees, so the outputs differ in the last bits:
rgb and opacity within ABS_TOL, depth within DEPTH_RTOL of itself, the
gradient to raw within GRAD_RTOL of its norm. A ray whose transmittance
lies within the two sums' rounding of eps at some sample (near_eps) may
weight that sample on one side only; such rays are left out of the
comparison and must stay rare (NEAR_SHARE).
"""
import math

import numpy as np
import pytest
import torch

from myc_nerfs_tpu_torch.ops.cuda import composite as cc
from myc_nerfs_tpu_torch.render import ngp_render as nr
from myc_nerfs_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

ABS_TOL = 1e-5
DEPTH_RTOL = 1e-5
GRAD_RTOL = 1e-5
NEAR_SHARE = 1e-3
EPS = 1e-4
RAYS = 4096                   # a render chunk: 4096 rays x 64 samples
BG = ["shared", "per_ray"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def launches() -> dict:
    torch.cuda.synchronize()
    counts = profiling.counts(traced=False)
    return {k: counts[f"launch.{k}"] for k in ("ngp_composite", "ngp_composite_bwd")}


def case(n: int, k: int, bg: str, device, seed: int = 0):
    """raw [n, k, 4] and MarchedRays (dt broadcast from one step per ray, as
    the march gives it; t increasing; valid) and bg [3] or [n, 3]. Ray 0
    has no valid sample, every 5th ray is all valid, every 4th dense
    (stopped early by eps), and raw_d lies above 30 and below -15 in
    places."""
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((n, k, 4), generator=g) * 3
    raw[1::4, :, 3] += 6.0
    raw[2::16, 1, 3] = 40.0
    raw[3::16, :4, 3] = -20.0
    dt = (torch.rand((n, 1), generator=g) * 0.05 + 1e-3).expand(n, k)
    t = torch.cumsum(torch.rand((n, k), generator=g) * 0.05, -1) + 0.2
    valid = torch.rand((n, k), generator=g) > 0.3
    valid[::5] = True
    valid[0] = False
    colour = torch.rand((n, 3) if bg == "per_ray" else (3,), generator=g)
    marched = nr.MarchedRays(positions=None, dirs=None, dt=dt.to(device), t=t.to(device),
                             valid=valid.to(device))
    return raw.to(device), marched, colour.to(device)


def near_eps(raw, marched, eps: float = EPS) -> torch.Tensor:
    """[N] bool: rays with a valid sample whose exclusive optical depth S
    (summed exactly, in f64, from the f32 sd) lies within the rounding of a
    K-term f32 sum of log(1 / eps), where T > eps may decide either way."""
    N, K, _ = raw.shape
    sd = torch.where(marched.valid, torch.exp(torch.clamp_max(raw[..., 3], 30.0)) * marched.dt,
                     0.0).double()
    S = torch.cumsum(torch.cat([torch.zeros_like(sd[:, :1]), sd[:, :-1]], -1), -1)
    level = -math.log(np.float32(eps))
    margin = 2 * K * 2.0 ** -24 * level + 1e-6
    return (marched.valid & ((S - level).abs() <= margin)).any(-1)


def output_errors(got, want, keep) -> dict:
    """The largest differences on the rays ``keep``: rgb and opacity
    absolute, depth relative to itself."""
    return {"rgb": (got.rgb - want.rgb)[keep].abs().max().item(),
            "opacity": (got.opacity - want.opacity)[keep].abs().max().item(),
            "depth_rel": ((got.depth - want.depth).abs()
                          / want.depth.abs().clamp_min(1e-30))[keep].max().item()}


def within_tolerances(errors: dict) -> bool:
    return (errors["rgb"] <= ABS_TOL and errors["opacity"] <= ABS_TOL
            and errors["depth_rel"] <= DEPTH_RTOL)


def assert_close_outputs(got, want, keep) -> None:
    for x in got[:3]:
        assert x.dtype == torch.float32 and x.is_cuda
    assert got.rgb.shape == want.rgb.shape and got.depth.shape == want.depth.shape
    assert got.opacity.shape == want.opacity.shape
    assert got.n_samples.dtype == torch.int64 and got.n_samples.shape == ()
    assert int(got.n_samples) == int(want.n_samples)
    errors = output_errors(got, want, keep)
    assert within_tolerances(errors), errors


@pytest.mark.parametrize("bg", BG)
@pytest.mark.parametrize("k", [64, 20, 100])
def test_forward_equals_plain(cuda, k, bg):
    """A render chunk's rays at K = 64 (render), 20 (an n_compact of the
    train schedule, under one warp's width) and 100 (four chunks, the last
    partial): one launch; n_samples exactly valid.sum()."""
    raw, marched, colour = case(RAYS, k, bg, cuda, seed=k)
    profiling.reset()
    with torch.no_grad():
        got = nr.composite_marched(raw, marched, colour, EPS)
        assert launches() == {"ngp_composite": 1, "ngp_composite_bwd": 0}
        want = nr.composite_marched_plain(raw, marched, colour, EPS)
    near = near_eps(raw, marched)
    assert int(near.sum()) <= max(1, int(NEAR_SHARE * RAYS)), int(near.sum())
    assert_close_outputs(got, want, ~near)
    # the cases are there: empty, all-valid and early-stopped rays, and the
    # clamps of raw_d
    assert got.opacity[0].item() == 0.0 and not marched.valid[0].any()
    assert marched.valid[5].all()
    assert (want.opacity[1::4] > 1 - 2 * EPS).float().mean().item() > 0.5
    assert (raw[..., 3] > 30).any() and (raw[..., 3] < -15).any()


def test_forward_twice_gives_the_same_bits(cuda):
    """The kernel keeps no state between launches and sums in a fixed
    order: a second launch gives the same count and the same bits."""
    raw, marched, colour = case(RAYS, 64, "shared", cuda, seed=3)
    with torch.no_grad():
        a = nr.composite_marched(raw, marched, colour, EPS)
        b = nr.composite_marched(raw, marched, colour, EPS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.n_samples) == int(marched.valid.sum())


def raw_grad(fn, raw, marched, colour, seed: int, which: str):
    """fn's outputs and the gradient to raw of a random linear function of
    rgb (training's loss reads rgb alone) or of rgb, depth and opacity."""
    r = raw.clone().requires_grad_()
    out = fn(r, marched, colour, EPS)
    g = torch.Generator(device=raw.device).manual_seed(seed)
    n = raw.shape[0]
    loss = (out.rgb * torch.randn((n, 3), device=raw.device, generator=g)).sum()
    if which == "all":
        loss = loss + (out.depth * torch.randn(n, device=raw.device, generator=g)).sum()
        loss = loss + (out.opacity * torch.randn(n, device=raw.device, generator=g)).sum()
    (grad,) = torch.autograd.grad(loss, r)
    return out, grad


@pytest.mark.parametrize("which", ["rgb", "all"])
@pytest.mark.parametrize("bg", BG)
@pytest.mark.parametrize("k", [64, 20])
def test_backward_equals_autograd(cuda, k, bg, which):
    """The backward kernel's gradient to raw against autograd through the
    eager composition: the norm of the difference over the norm, on the
    rays away from eps; one forward and one backward launch."""
    raw, marched, colour = case(RAYS, k, bg, cuda, seed=10 + k)
    profiling.reset()
    got_out, got = raw_grad(nr.composite_marched, raw, marched, colour, 7, which)
    assert launches() == {"ngp_composite": 1, "ngp_composite_bwd": 1}
    want_out, want = raw_grad(nr.composite_marched_plain, raw, marched, colour, 7, which)
    keep = ~near_eps(raw, marched)
    assert_close_outputs(got_out, want_out, keep)
    err = ((got - want)[keep].norm() / want[keep].norm()).item()
    assert err <= GRAD_RTOL, err
    assert torch.isfinite(got).all()
    # samples past a spent ray's stop, and invalid ones, get exactly 0
    assert (got[0] == 0).all()


def test_no_rays(cuda):
    f32 = dict(dtype=torch.float32, device=cuda)
    marched = nr.MarchedRays(positions=None, dirs=None, dt=torch.zeros((0, 64), **f32),
                             t=torch.zeros((0, 64), **f32),
                             valid=torch.zeros((0, 64), dtype=torch.bool, device=cuda))
    profiling.reset()
    with torch.no_grad():
        out = nr.composite_marched(torch.zeros((0, 64, 4), **f32), marched,
                                   torch.ones(3, **f32), EPS)
    assert launches()["ngp_composite"] == 0
    assert out.rgb.shape == (0, 3) and out.depth.shape == (0,) and int(out.n_samples) == 0


def leaf_grads(fn, raw, marched, colour, keep, seed: int, eps: float = EPS):
    """fn's outputs and the gradients of a random linear function of rgb,
    depth and opacity to raw, dt (one step per ray, broadcast over the
    samples as the march gives it), t and the background, each a leaf; the
    rays not in ``keep`` get no cotangent, so that both sides agree on
    them exactly."""
    n, k, _ = raw.shape
    leaves = {"raw": raw.clone(), "dt": marched.dt[:, :1].clone(), "t": marched.t.clone(),
              "bg": colour.clone()}
    for x in leaves.values():
        x.requires_grad_()
    out = fn(leaves["raw"], marched._replace(dt=leaves["dt"].expand(n, k), t=leaves["t"]),
             leaves["bg"], eps)
    g = torch.Generator(device=raw.device).manual_seed(seed)
    mask = keep.float()

    def cotangent(*shape):
        return torch.randn(shape, device=raw.device, generator=g) * mask.reshape(
            (n,) + (1,) * (len(shape) - 1))

    loss = ((out.rgb * cotangent(n, 3)).sum() + (out.depth * cotangent(n)).sum()
            + (out.opacity * cotangent(n)).sum())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return out, dict(zip(leaves, grads))


def assert_close_grads(got: dict, want: dict) -> None:
    """Each gradient within GRAD_RTOL of its norm, finite, and not zero."""
    for name in want:
        err = ((got[name] - want[name]).norm() / want[name].norm()).item()
        assert err <= GRAD_RTOL, (name, err)
        assert torch.isfinite(got[name]).all() and want[name].abs().sum() > 0, name


@pytest.mark.parametrize("bg", BG)
@pytest.mark.parametrize("k", [64, 20])
def test_kernels_where_dt_t_or_bg_require_grad(cuda, k, bg):
    """Test-time pose optimisation differentiates dt and t (through the
    march's backward): the kernels run then too, one launch each way, and
    the gradients to raw, dt, t and the background equal autograd's through
    the eager composition."""
    raw, marched, colour = case(RAYS, k, bg, cuda, seed=30 + k)
    keep = ~near_eps(raw, marched)
    profiling.reset()
    got_out, got = leaf_grads(nr.composite_marched, raw, marched, colour, keep, 9)
    assert launches() == {"ngp_composite": 1, "ngp_composite_bwd": 1}
    want_out, want = leaf_grads(nr.composite_marched_plain, raw, marched, colour, keep, 9)
    assert_close_outputs(got_out, want_out, keep)
    assert_close_grads(got, want)


@pytest.mark.parametrize("batch", ["render", "train"])
def test_backward_on_marched_car_samples(cuda, batch):
    """The backward on samples the fused march places through Car's
    occupancy grid and raw from Car's field, the inputs chip_smoke's phase
    5d compares: 20480 rays at K = n_samples (a render's) or n_compact
    (training's), per-ray backgrounds, cotangents on rgb, depth and
    opacity; the gradients to raw, dt, t and the background against
    autograd through the eager composition."""
    from test_torch_cuda_rgb_input import car_trainer

    trainer = car_trainer(7, True)
    rcfg = trainer.rcfg
    K = rcfg.n_samples if batch == "render" else rcfg.n_compact
    g = torch.Generator(device="cuda").manual_seed(7)
    N = 20480
    o = torch.full((N, 3), 0.5, device="cuda") + 0.01 * torch.randn((N, 3), device="cuda",
                                                                     generator=g)
    d = torch.randn((N, 3), device="cuda", generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    xi = None if batch == "render" else torch.rand((N, 1), device="cuda", generator=g)
    colour = torch.rand((N, 3), device="cuda", generator=g)
    with torch.no_grad():
        marched = nr.march_rays_fused(trainer.occ_cfg, rcfg, trainer.state.occ, o, d, xi,
                                      n_samples=K)
        raw = trainer.model(marched.positions.reshape(-1, 3),
                            marched.dirs.reshape(-1, 3)).reshape(N, K, 4)
    assert marched.valid.float().mean().item() > 0.05
    eps = rcfg.early_stop_eps
    keep = ~near_eps(raw, marched, eps)
    assert int((~keep).sum()) <= max(1, int(NEAR_SHARE * N))
    profiling.reset()
    got_out, got = leaf_grads(nr.composite_marched, raw, marched, colour, keep, 8, eps)
    assert launches() == {"ngp_composite": 1, "ngp_composite_bwd": 1}
    want_out, want = leaf_grads(nr.composite_marched_plain, raw, marched, colour, keep, 8, eps)
    assert_close_outputs(got_out, want_out, keep)
    assert_close_grads(got, want)


def test_wrapper_raises(cuda):
    raw, marched, colour = case(64, 8, "shared", cuda)
    dt, t, valid = marched.dt, marched.t, marched.valid
    for args, kind in (((raw.half(), dt, t, valid, colour), TypeError),
                       ((raw, dt, t, valid.float(), colour), TypeError),
                       ((raw[..., :3], dt, t, valid, colour), ValueError),
                       ((raw, dt[:, :4], t, valid, colour), ValueError),
                       ((raw, dt, t, valid, colour[:2]), ValueError),
                       ((raw, dt.cpu(), t, valid, colour), ValueError)):
        with pytest.raises(kind):
            cc.ngp_composite(*args, EPS)


def test_render_frame_close_to_plain(cuda, monkeypatch):
    """A whole render_image frame (200 x 200: ten 4096-ray chunks, the last
    padded with zero rays) of Car's field through the kernel, one launch a
    chunk, against the frame composited by the eager composition."""
    from test_torch_cuda_rgb_input import car_trainer

    trainer = car_trainer(5, True)
    H = W = 200
    intr = torch.tensor([[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1.0]])
    c2w = torch.eye(4)
    c2w[:3, 3] = 0.5
    profiling.reset()
    with torch.no_grad():
        rgb_k, depth_k = trainer.render_image(c2w, intr, H, W)
        n = launches()
        monkeypatch.setattr(nr, "composite_marched", nr.composite_marched_plain)
        rgb_p, depth_p = trainer.render_image(c2w, intr, H, W)
    assert n == {"ngp_composite": math.ceil(H * W / 4096), "ngp_composite_bwd": 0}
    off = (rgb_k - rgb_p).abs().amax(-1) > ABS_TOL
    assert off.float().mean().item() <= NEAR_SHARE, int(off.sum())
    assert (rgb_k - rgb_p).abs().max().item() < 1e-3
    bg = torch.tensor(trainer.cfg.background_color, device="cuda")
    assert (rgb_k - bg).abs().max().item() > 1e-3, "the frame is all background"


def test_train_step_through_the_kernels(cuda):
    """NGPTrainer.forward and backward on a batch of Car rays (n_compact
    samples, per-ray backgrounds as train_step passes them): one forward
    and one backward launch, and the gradient of the loss to the field's
    raw output equal to autograd through the eager composition."""
    from test_torch_cuda_rgb_input import car_trainer

    trainer = car_trainer(6, True)
    g = torch.Generator(device="cuda").manual_seed(6)
    B = 4096
    o = torch.full((B, 3), 0.5, device="cuda") + 0.01 * torch.randn((B, 3), device="cuda",
                                                                     generator=g)
    d = torch.randn((B, 3), device="cuda", generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    target = torch.rand((B, 3), device="cuda", generator=g)
    bg = torch.ones(3, device="cuda").expand(B, 3)
    xi = torch.rand((B, 1), device="cuda", generator=g)
    profiling.reset()
    loss, out = trainer.forward(o, d, target, bg, xi)
    trainer.backward(loss)
    assert launches() == {"ngp_composite": 1, "ngp_composite_bwd": 1}

    # the same batch's marched samples and raw, composited both ways
    occ = trainer.state.occ
    marched = nr.march_rays_fused(trainer.occ_cfg, trainer.rcfg, occ, o, d, xi,
                                  n_samples=trainer.rcfg.n_compact)
    N, K, _ = marched.positions.shape
    with torch.no_grad():
        raw = trainer.model(marched.positions.reshape(-1, 3),
                            marched.dirs.reshape(-1, 3)).reshape(N, K, 4)
    assert marched.valid.float().mean().item() > 0.05
    got_out, got = raw_grad(nr.composite_marched, raw, marched, bg, 8, "rgb")
    want_out, want = raw_grad(nr.composite_marched_plain, raw, marched, bg, 8, "rgb")
    keep = ~near_eps(raw, marched, trainer.rcfg.early_stop_eps)
    assert_close_outputs(got_out, want_out, keep)
    assert int(got_out.n_samples) == int(out.n_samples)
    err = ((got - want)[keep].norm() / want[keep].norm()).item()
    assert err <= GRAD_RTOL, err
