"""The yardstick's arithmetic on known shapes: peaks, bounds, the MLP,
encode and factor work, the field FLOPs behind the MFUs, and the trace
reductions (busy union, time by name, idle gaps by host activity)."""
import pytest

from benchmark.bounds import factor_sampling
from benchmark.families import ngp, tensorf
from benchmark.lib import work
from benchmark.lib.profile import Trace, top
from benchmark.reference import ngp as ngp_ref
from benchmark.reference import tensorf as tf_ref


def test_peaks_and_bounds():
    assert work.peak_flops("bf16") == 989e12
    assert work.peak_flops("f32") == pytest.approx(165e12)
    # 3.35 GB at 3.35 TB/s is 1 ms; 989 GFLOP of bf16 is 1 ms
    assert work.bound_s(0.0, 3.35e9, "bf16") == pytest.approx(1e-3)
    assert work.bound_s(989e9, 0.0, "bf16") == pytest.approx(1e-3)
    # f32 FLOPs count three TF32 passes
    assert work.bound_s(165e9, 0.0, "f32") == pytest.approx(1e-3)


def test_mlp_work_of_the_ngp_density_mlp():
    rows = 262144
    f, n = work.mlp_work([32, 64, 16], rows, "bf16")
    assert f == 2 * rows * (32 * 64 + 64 * 16)
    assert n == (rows * (32 + 16) + 32 * 64 + 64 * 16) * 2
    fb, nb = work.mlp_work([32, 64, 16], rows, "bf16", backward=True)
    assert fb == 2 * rows * (32 * 64 + 2 * (32 * 64 + 64 * 16))
    assert nb == (rows * (2 * 32 + 16) + 2 * (32 * 64 + 64 * 16)) * 2


def test_encode_and_factor_work():
    f, n = work.encode_work(1000, 16, 2, 5000, "bf16")
    assert f == 1000 * 16 * 8 * 6 and n == 1000 * 12 + 1000 * 32 * 2 + 5000 * 4
    _, nb = work.encode_work(1000, 16, 2, 5000, "bf16", backward=True)
    assert nb == 1000 * 12 + 1000 * 32 * 2 + 5000 * 8
    f, n = work.factor_work(100, 16, (8, 8), 8, 64, 16)
    assert f == 100 * 16 * 12 and n == 100 * 12 + 2 * 100 * 16 * 4 + 80 * 4


def test_field_flops_per_sample():
    spec = ngp_ref.NGPSpec(aabb_scale=4)
    assert ngp.field_flops(spec) == 2 * (32 * 64 + 64 * 16) + 2 * (32 * 64 + 64 * 64 + 64 * 3)
    s = tf_ref.TensoRFSpec(aabb=((0, 0, 0), (1, 1, 1)), grid=(8, 8, 8), step_size=0.1,
                           n_samples=10)
    dens, app = tensorf.field_flops(s)
    assert dens == 14 * 48
    assert app == 14 * 144 + 2 * 144 * 27 + 2 * (150 * 128 + 128 * 128 + 128 * 3)


def test_texel_counts():
    import torch

    x = torch.tensor([-1.0, -1.0, 1.0])
    y = torch.tensor([-1.0, -1.0, 1.0])
    # two distinct cells of a 5x5 plane: the corner cell and the far cell
    assert factor_sampling.plane_texels(x, y, 5, 5) == 8
    assert factor_sampling.line_texels(torch.tensor([0.0]), 5) == 2


def test_trace_reductions():
    t = Trace()
    t.wall_s = 30e-6
    t.device = [("k1", 0.0, 4.0), ("k2", 2.0, 6.0), ("k1", 10.0, 12.0), ("k3", 20.0, 25.0)]
    t.host = [("outer", 0.0, 30.0), ("aten::nonzero", 6.5, 9.0), ("sync", 13.0, 19.0)]
    assert t.busy_intervals() == [(0.0, 6.0), (10.0, 12.0), (20.0, 25.0)]
    assert t.busy_s() == pytest.approx(13e-6)
    assert t.by_name() == pytest.approx({"k1": 6e-6, "k2": 4e-6, "k3": 5e-6})
    assert t.seconds_matching(["k1", "k3"]) == pytest.approx(11e-6)
    gaps = t.idle_gaps()
    assert gaps == pytest.approx({"aten::nonzero": 4e-6, "sync": 8e-6})
    assert top(gaps, 1) == [["sync", pytest.approx(8e-6)]]
