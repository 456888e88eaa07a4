"""The plain reference against the port, at a small size on the CPU: the
brick3 encode, the occupancy update, the fused march, whole-frame renders,
the first train steps, and the TensoRF forward. The reference imports
nothing of the port; these tests hand both the same inputs."""
import ast

import numpy as np
import pytest
import torch

from benchmark.reference import ngp as ref
from benchmark.reference import tensorf as tf_ref
from conftest import ROOT

SPEC = ref.NGPSpec(aabb_scale=4, n_levels=6, log2_hashmap_size=12, n_coarse=64,
                   n_samples=16, n_compact=16, n_grid_uniform=2048, n_grid_nonuniform=2048)


@pytest.mark.parametrize("module", ["ngp.py", "tensorf.py"])
def test_reference_imports_only_torch_and_numpy(module):
    tree = ast.parse((ROOT / "benchmark" / "reference" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "dataclasses", "math", "typing", "numpy",
                     "torch"}


def _port_model(spec, seed=0):
    from myc_nerfs_tpu_torch.models.ngp import HashGridConfig, NGPModel, NGPModelConfig

    grid = HashGridConfig(n_levels=spec.n_levels, log2_hashmap_size=spec.log2_hashmap_size,
                          aabb_scale=spec.aabb_scale)
    model = NGPModel(NGPModelConfig(grid=grid, use_fully=False), device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    model.use_encode_kernel = False
    with torch.no_grad():
        for t in model.tables:
            t.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(seed + 1))
    return model


def test_brick3_layout_and_encode_match_the_port():
    model = _port_model(SPEC)
    assert [tuple(t.shape) for t in model.tables] == ref.table_shapes(SPEC)
    pos = torch.rand((5000, 3), generator=torch.Generator().manual_seed(3))
    want = model.encode(pos)
    got = ref.encode(list(model.tables), pos, SPEC, ref.bricks(SPEC))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _occupancy(seed=0):
    from myc_nerfs_tpu_torch.render import occupancy as occ

    cfg = occ.OccupancyConfig(max_cascade=SPEC.max_cascade)
    g = torch.Generator().manual_seed(seed)
    grid = torch.rand((5, 128, 128, 128), generator=g) * 0.02 - 0.002
    bits, mean = ref.bitfield(grid)
    return cfg, occ.OccupancyState(grid, bits, mean, torch.zeros((), dtype=torch.int32)), \
        ref.Occupancy(grid, bits, mean)


def test_occupancy_update_matches_the_port():
    from myc_nerfs_tpu_torch.render import occupancy as occ

    model = _port_model(SPEC)
    cfg, state, mine = _occupancy()
    draws = tuple(ref.grid_draws(SPEC, 2048, torch.Generator().manual_seed(s), "cpu")
                  for s in (1, 2))
    update = occ.make_density_grid_update(cfg, model.density_raw, 2048, 2048,
                                          aabb=SPEC.aabb)
    want = update(state, draws=tuple(occ.GridDraws(*d) for d in draws))
    weights = {n: getattr(model.net, n) for n in ref.LAYERS}
    got = ref.update_occupancy(SPEC, ref.Field(SPEC, list(model.tables), weights), mine, draws)
    torch.testing.assert_close(got.grid, want.density_grid, rtol=1e-5, atol=1e-9)
    assert torch.equal(got.bits, want.bitfield)


def test_fused_march_matches_the_port():
    from myc_nerfs_tpu_torch.render.ngp_render import NGPRenderConfig, march_rays_fused

    cfg, state, mine = _occupancy(4)
    g = torch.Generator().manual_seed(5)
    o = torch.rand((256, 3), generator=g) * 0.2 + 0.4 + torch.tensor([1.2, 0.0, 0.0])
    d = torch.nn.functional.normalize(torch.tensor([-1.0, 0.1, 0.05]) +
                                      0.2 * torch.randn((256, 3), generator=g), dim=-1)
    xi = torch.rand((256, 1), generator=g)
    rcfg = NGPRenderConfig(aabb_scale=4, n_coarse=SPEC.n_coarse)
    want = march_rays_fused(cfg, rcfg, state, o, d, xi, n_samples=16)
    got = ref.march(SPEC, mine, o, d, 16, xi)
    assert want.valid.any()
    assert torch.equal(got.valid, want.valid)
    torch.testing.assert_close(got.pos, want.positions)
    torch.testing.assert_close(got.dt, want.dt)


@pytest.mark.parametrize("name", ["ngp_car.train", "ngp_car.render", "tensorf_coffee.train"])
def test_the_checks_pass_on_the_port(name):
    """A whole run at a small size: the reference follows the port within
    the cell's limits (the first train steps, or the rendered frames)."""
    import time

    from benchmark.lib import harness
    from benchmark.tests.sizes import TINY

    line = harness.run_cell(ROOT, name, 77, 0.0, False, "cpu", time.perf_counter(), TINY[name])
    assert line["correct"], line["checks"]


def test_tensorf_forward_matches_the_port():
    from myc_nerfs_tpu_torch.models import tensorf as tf

    spec = tf_ref.TensoRFSpec(aabb=((-0.3, -1.0, -0.8), (0.3, 1.1, 0.7)), grid=(9, 21, 17),
                              step_size=0.05, n_samples=60)
    cfg = tf.TensoRFConfig(view_pe=2, fea_pe=2, step_ratio=0.5, near_far=(0.5, 6.0),
                           ray_march_weight_thres=1e-3)
    g = torch.Generator().manual_seed(0)
    shapes = tf_ref.leaf_shapes(spec)
    init = {n: (torch.randn(s, generator=g) * (2.0 if "density" in n else 0.3)) for n, s in
            shapes.items()}
    for i in range(3):
        init[f"density_plane.{i}"][0] += 4.0
    aabb = torch.tensor(spec.aabb)
    params, buffers = tf.init_tensorf(cfg, np.asarray(spec.aabb), spec.grid, g)
    for key in ("app_line", "app_plane", "density_line", "density_plane"):
        params[key] = [init[f"{key}.{i}"].clone() for i in range(3)]
    params["basis_mat"] = init["basis_mat"].clone()
    with torch.no_grad():
        for n, p in params["mlp"].named_parameters():
            p.copy_(init[f"mlp.{n}"])
    geom = tf.StageGeom(spec.grid, spec.step_size, spec.n_samples, (0.0, 0.0, 0.0))
    buffers, _ = tf.update_alpha_mask(cfg, geom, params, buffers, spec.grid)
    vol = tf_ref.alpha_mask(spec, init, aabb)
    assert torch.equal(vol, buffers["alpha_volume_dil"])
    o = torch.tensor([2.0, 0.1, 0.0]) + 0.1 * torch.randn((128, 3), generator=g)
    d = torch.nn.functional.normalize(-o + 0.1 * torch.randn((128, 3), generator=g), dim=-1)
    rays = torch.cat([o, d], -1)
    jitter = torch.rand((128, 1), generator=g)
    want = tf.tensorf_forward(cfg, geom, params, buffers, rays, jitter)
    got = tf_ref.forward(spec, init, vol, aabb, rays, jitter)
    assert torch.equal(got.valid, want.extras["valid"])
    assert got.shaded.any()
    torch.testing.assert_close(got.rgb, want.rgb_map, rtol=1e-5, atol=1e-5)
