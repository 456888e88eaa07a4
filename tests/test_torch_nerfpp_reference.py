"""The port's NeRF++ (models/nerfpp.py::nerfpp_forward through
TensoRFTrainer.loss) against the benchmark's plain reference
(benchmark/reference/tensorf_nerfpp.py), with neither JAX nor the JAX
package: Scarf's configuration cut to a CPU's size (a (47, 16, 47) factor
grid in Scarf's box, 64 rays, 32 foreground and 16 background samples,
bg_D 3), seeded random weights, the benchmark's own cameras inside the
sphere; and the NeRF++ spans and counter while a profiler records.

Tolerances. The two sides compute the same f32 arithmetic in other orders:
grid_sample's taps and its atomic backward against the reference's gathers
and index_put sums, MLP_Fea's F.linear against ``x @ W + b``; the
background follows the published code's order (bitwise equal here but for
the foreground's transmittance that weights it). Those orders move a value
by a few f32 ulps (~1e-7 of its scale); a sum over many samples or rays,
and a product through the transmittances, by more. The limits are 1e-5 of
each quantity's scale for the maps and the loss, and 1e-4 of each leaf's
largest gradient element: thirty to eighty times the readings (rgb 1.2e-7,
depth 6.9e-8, the loss equal, the worst leaf, bg_net.Dense_3.kernel,
3.0e-6), and some nine hundred times below what a wrong draw leaves in the
rgb (the foreground's jitter left out 9.1e-3, the background's draws
mirrored 5.2e-2).
"""
import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.families import tensorf_nerfpp as fam
from benchmark.lib import catalog, harness
from benchmark.reference import tensorf as ref
from benchmark.reference import tensorf_nerfpp as pref
from myc_nerfs_tpu_torch.models import tensorf as tf
from myc_nerfs_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"config": {"tensorf": {"batch_size": 64, "bg_samples": 16, "nSamples": 32},
                    "stage": {"n_voxels": 36864},
                    "scene": {"views": 2, "H": 16, "W": 16, "gt_samples": 32}}}
MAP_TOL, GRAD_TOL = 1e-5, 1e-4


def _config():
    bench = catalog.load(ROOT)
    config = copy.deepcopy(catalog.config(ROOT, bench, "tensorf_scarf"))
    harness.merge({"config": config}, SMALL)
    return config


@pytest.fixture(scope="module")
def case():
    """The trainer at the small stage with the seed's weights, 64 rays of
    the benchmark's views, their targets and draws."""
    config = _config()
    trainer, spec, init, rays, rgbs = fam.build(config, 20240601, "cpu")
    g = torch.Generator().manual_seed(7)
    ids = torch.randperm(rays.shape[0], generator=g)[:64]
    draws = (torch.rand((64, spec.fg.n_samples), generator=g),
             torch.rand((64, spec.bg_samples), generator=g))
    return {"trainer": trainer, "spec": spec, "init": init, "rays": rays[ids],
            "rgbs": rgbs[ids], "draws": draws}


def _reference(case):
    spec, init = case["spec"], case["init"]
    p = {n: init[n].clone().requires_grad_(True) for n in pref.leaf_shapes(spec)}
    aabb = torch.tensor(spec.fg.aabb, dtype=torch.float32)
    vol = ref.alpha_mask(spec.fg, p, aabb)
    fwd = pref.forward(spec, p, vol, aabb, case["rays"], case["draws"])
    total = ref.loss(spec.fg, p, fwd, case["rgbs"], case["trainer"].global_step)
    return p, fwd, total


@pytest.fixture(scope="module")
def both(case):
    """(port's output, loss and gradients by leaf name; the reference's)."""
    trainer, spec = case["trainer"], case["spec"]
    spatial, net = tf.group_leaves(trainer.params)
    names = [n for n in pref.leaf_shapes(spec) if ref.is_spatial(n)] + \
        [n for n in pref.leaf_shapes(spec) if not ref.is_spatial(n)]
    with torch.enable_grad():
        total, _, out = trainer.loss(case["rays"], case["rgbs"], case["draws"])
        grads = torch.autograd.grad(total, spatial + net, allow_unused=True)
    port = {"out": out, "loss": float(total.detach()),
            "grads": {n: torch.zeros_like(t) if g is None else g
                      for n, t, g in zip(names, spatial + net, grads)}}
    p, fwd, total_r = _reference(case)
    grads_r = torch.autograd.grad(total_r, [p[n] for n in names], allow_unused=True)
    reference = {"fwd": fwd, "loss": float(total_r.detach()),
                 "grads": {n: torch.zeros_like(p[n]) if g is None else g
                           for n, g in zip(names, grads_r)}}
    return port, reference


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_the_small_stage_is_scarfs_shape(case):
    spec = case["spec"]
    assert spec.fg.grid == (47, 16, 47) and spec.fg.n_samples == 32
    assert (spec.bg_D, spec.bg_freq, spec.bg_view_freq, spec.radii) == (3, 2, 2, 28.0)
    assert tuple(case["trainer"].geom.grid_size) == spec.fg.grid
    shapes = pref.leaf_shapes(spec)
    assert shapes["bg_net.Dense_2.kernel"] == (148, 128)
    assert shapes["bg_net.Dense_5.kernel"] == (271, 64)
    assert [tuple(p.shape) for p in case["trainer"].params["bg_net"].parameters()] == [
        s for n, s in shapes.items() if n.startswith("bg_net.")]


def test_forward_maps_match_the_reference(both):
    port, reference = both
    out, fwd = port["out"], reference["fwd"]
    assert torch.equal(out.extras["valid"], fwd.valid)
    assert torch.equal(out.extras["app_mask"], fwd.shaded)
    # the background is gated on for some rays and off for others
    lam = out.bg_weight[:, 0]
    assert bool((lam > 0).any()) and bool((lam == 0).any())
    assert _rel(out.rgb_map, fwd.rgb) < MAP_TOL
    assert _rel(out.depth_map, fwd.depth) < MAP_TOL


def test_loss_matches_the_reference(both):
    port, reference = both
    assert abs(port["loss"] - reference["loss"]) <= MAP_TOL * abs(reference["loss"])


@pytest.mark.parametrize("leaf", list(pref.leaf_shapes(pref.nerfpp_spec(_config()))))
def test_leaf_gradient_matches_the_reference(both, leaf):
    port, reference = both
    g, g_ref = port["grads"][leaf], reference["grads"][leaf]
    assert g.shape == g_ref.shape
    assert float(g_ref.abs().max()) > 0.0
    assert _rel(g, g_ref) < GRAD_TOL, leaf


def test_the_limits_see_a_wrong_draw(case, both):
    """The limits are not loose: the reference given the background's draws
    in mirrored order reads far outside them."""
    port, _ = both
    c = dict(case, draws=(case["draws"][0], case["draws"][1].flip(1)))
    _, fwd, _ = _reference(c)
    assert _rel(port["out"].rgb_map, fwd.rgb) > 100 * MAP_TOL


def test_the_reference_imports_no_jax_and_no_port_module():
    allowed = {"__future__", "dataclasses", "typing", "numpy", "torch"}
    for name in ("tensorf_nerfpp.py", "tensorf.py"):
        tree = ast.parse((ROOT / "benchmark" / "reference" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # the TensoRF reference beside it
                    assert node.module is None and [a.name for a in node.names] == [
                        "tensorf"], (name, node.module)
                    continue
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert tops <= allowed, (name, tops)


def test_a_traced_step_records_the_nerfpp_spans_and_counter():
    """One train step under a CPU profiler: the foreground's tensorf.* spans
    and the background's nerfpp.* spans (all declared) inside tensorf.step,
    once each, and nerfpp.bg_samples = rays x bg_samples in the traced and
    host totals; without a profiler only the host total adds."""
    trainer, spec, _, rays, rgbs = fam.build(_config(), 11, "cpu")
    rays, rgbs = rays[:32], rgbs[:32]
    g = torch.Generator().manual_seed(3)
    draws = (torch.rand((32, spec.fg.n_samples), generator=g),
             torch.rand((32, spec.bg_samples), generator=g))
    names = ("tensorf.sample", "tensorf.density", "tensorf.shade", "tensorf.composite",
             "nerfpp.bg_points", "nerfpp.bg_mlp", "nerfpp.bg_composite")
    assert set(names) <= set(profiling.SPANS) and "nerfpp.bg_samples" in profiling.COUNTERS
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(rays, rgbs, draws)
    inside = {}
    for e in prof.events():
        if e.name not in profiling.SPANS:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in profiling.SPANS:
            parent = parent.cpu_parent
        key = (e.name, parent.name if parent is not None else None)
        inside[key] = inside.get(key, 0) + 1
    for name in names:
        assert inside.get((name, "tensorf.step")) == 1, (name, inside)
    n = 32 * spec.bg_samples
    assert profiling.counts(traced=True)["nerfpp.bg_samples"] == n
    assert profiling.counts()["nerfpp.bg_samples"] == n
    with torch.no_grad():
        trainer.forward(trainer.params, rays, draws)
    assert profiling.counts()["nerfpp.bg_samples"] == 2 * n
    assert profiling.counts(traced=True)["nerfpp.bg_samples"] == n
    profiling.reset()


def test_cameras_sit_inside_the_sphere_and_the_object_beyond_near():
    config = _config()
    aabb = np.asarray(config["tensorf"]["bbox"], np.float64).reshape(2, 3)
    center = (aabb[0] + aabb[1]) / 2
    reach = ((aabb[1] - aabb[0]) / 2 * np.asarray(config["object"]["radii"])).max()
    for c in fam.cameras(config, 2 ** 31 + 77):
        pos = c[:, 3].numpy().astype(np.float64)
        assert np.linalg.norm(pos) < config["tensorf"]["radii"]
        assert np.linalg.norm(pos - center) - reach > config["tensorf"]["near"]
    bad = copy.deepcopy(config)
    bad["scene"]["rings"] = [[29.0, 8.0]]
    with pytest.raises(ValueError):
        fam.cameras(bad, 1)


def test_the_environment_is_smooth_and_not_white():
    u = torch.nn.functional.normalize(torch.randn(4096, 3, generator=torch.Generator()
                                                  .manual_seed(3)), dim=-1)
    c = fam.environment(u)
    assert float(c.min()) > 0.05 and float(c.max()) < 0.95
    assert float((c - 1.0).abs().min()) > 0.05
    # a small turn of the direction moves the colour little
    v = torch.nn.functional.normalize(u + 1e-3 * torch.randn_like(u), dim=-1)
    assert float((fam.environment(v) - c).abs().max()) < 1e-2
