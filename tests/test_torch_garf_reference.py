"""The port's GARF train step (train/nerf_trainer.py through
cli/train.config_to_train_config of configs/barf/Easyship.yaml) against the
benchmark's plain reference (benchmark/reference/garf.py), with neither JAX
nor the JAX package: Easyship's widths and rates, cut to a CPU's size (4
views of 16x16, 16 pixels a view, 8 samples per ray), the benchmark's
state at global step 100,000 past the pose gate (its seeded TF-Xavier
weights, zero corrections and first moments, second moments at the
gradients' scale) and its draws, the benchmark's own scene and cameras.

Tolerances. Both sides run the field as the same F.linear products on the
same inputs and the gaussian in one form, so the first gradients agree to
rounding: the se(3) corrections, the poses, the rays and the compositing
are written in other orders (the published Taylor series in |w| against
the port's in w.w, F.normalize against the port's +1e-8), which moves a
value by a few f32 ulps. The limits: the first loss to 1e-6 of itself,
each leaf's first gradient to 1e-5 of its largest element (readings, 8
seeds: the loss equal, the worst leaf 4.1e-7). With second moments at the
gradients' scale every update is smooth in its gradient, so after three
steps each leaf's change norm is held to 2e-4, the corrections' change to
2e-3 of its norm and each loss to 5e-5 (readings, 8 seeds: 2.2e-5, 1.3e-4,
6.4e-6), against what one wrong draw (the second step's jitter given to
the third) leaves: 0.041-0.108 in the worst leaf's change, 0.37-0.89 in
the corrections'. Taken each from the state the port started it from, as
the benchmark's check takes them, the three steps' losses are equal and
the changes held to 1e-5 (readings, 8 seeds: 4.6e-7 in the worst leaf,
3.6e-7 in the corrections), against 0.041 and 0.287 of the wrong draw.
"""
import ast
import copy
from pathlib import Path

import pytest
import torch

from benchmark.families import garf as fam
from benchmark.lib import catalog, harness
from benchmark.reference import garf as gref
from myc_nerfs_tpu_torch.train import nerf_trainer as nt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEP = 100000
LOSS_TOL, GRAD_TOL, CHANGE_TOL, POSE_TOL, STEPS_LOSS_TOL = 1e-6, 1e-5, 2e-4, 2e-3, 5e-5
EACH_TOL = 1e-5


def _config():
    config = copy.deepcopy(catalog.config(ROOT, catalog.load(ROOT), "garf_easyship"))
    barf = copy.deepcopy(config["barf"])
    barf["nerf"].update(rand_rays=64, sample_intvs=8)
    barf["data"]["image_size"] = [16, 16]
    harness.merge({"config": config}, {"config": {
        "barf": {"nerf": barf["nerf"], "data": barf["data"]},
        "scene": {"views": 4, "gt_samples": 32, "render_rows": 16}}})
    return config


def _leaves(spec):
    return gref.leaf_names(spec) + ["se3_refine"]


@pytest.fixture(scope="module")
def run():
    """The program at the small size, its state at STEP, three steps' draws."""
    b = fam.build(_config(), 20261019, "cpu")
    V, H, W = b.images.shape[:3]
    draws = [fam.draw(b.tcfg, V, H, W, b.gen, "cpu") for _ in range(3)]
    return b, draws


def _port_grads(b, state, draws):
    loss_fn = nt.make_loss(b.tcfg, b.images, b.poses, b.intr)
    params = state.params.param_list()
    se3 = state.se3_refine.detach().clone().requires_grad_(True)
    loss, _ = loss_fn(state._replace(se3_refine=se3), draws)
    grads = torch.autograd.grad(loss, params + [se3], allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(t) if g is None else g
                                  for n, t, g in zip(_leaves(b.spec), params + [se3], grads)}


def _ref_grads(b, step, draws):
    loss, grads = gref.gradients(b.spec, b.init, b.state.se3_refine, step, b.images, b.poses,
                                 b.intr, draws.ray_idx, draws.depth)
    return loss, dict(zip(_leaves(b.spec), grads))


@pytest.fixture(scope="module")
def first(run):
    b, draws = run
    return _port_grads(b, b.state, draws[0]), _ref_grads(b, STEP, draws[0])


@pytest.fixture(scope="module")
def three(run):
    """(the port's state after three steps, the reference's trace of them)."""
    b, draws = run
    step = nt.make_train_step(b.tcfg, b.images, b.poses, b.intr)
    state = b.state._replace(params=copy.deepcopy(b.state.params))
    losses = []
    for d in draws:
        state, m = step(state, d)
        losses.append(float(m["loss"]))
    trace = gref.train_steps(b.spec, b.init, b.state.se3_refine, b.images, b.poses, b.intr,
                             [(d.ray_idx, d.depth) for d in draws], STEP, b.nu)
    return state, losses, trace


@pytest.fixture(scope="module")
def each(run):
    """(the port's state after three steps, its losses, the reference's
    trace of the same steps, each taken from the state the port started it
    from), as the benchmark's check takes them."""
    b, draws = run
    step = nt.make_train_step(b.tcfg, b.images, b.poses, b.intr)
    state = b.state._replace(params=copy.deepcopy(b.state.params))
    names = gref.leaf_names(b.spec)
    started, losses = [], []
    for d in draws:
        started.append(({n: t.detach().clone() for n, t in zip(names, state.params.param_list())},
                        state.se3_refine.detach().clone()))
        state, m = step(state, d)
        losses.append(float(m["loss"]))
    trace = gref.train_steps(b.spec, b.init, b.state.se3_refine, b.images, b.poses, b.intr,
                             [(d.ray_idx, d.depth) for d in draws], STEP, b.nu, states=started)
    return state, losses, trace


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_the_small_run_keeps_easyships_widths(run):
    b, draws = run
    assert b.tcfg.widths_feat == (256,) * 6 and b.tcfg.skip == (3,)
    assert [tuple(p.shape) for p in b.state.params.param_list()[::2]] == \
        gref.layer_widths(b.spec)
    assert int(b.state.step) == STEP >= b.spec.start_pose_correct_iter
    assert tuple(draws[0].depth.shape) == (4, 16, 8, 1)


def test_loss_matches_the_reference(first):
    (loss, _), (loss_r, _) = first
    assert abs(loss - loss_r) <= LOSS_TOL * abs(loss_r)


@pytest.mark.parametrize("leaf", _leaves(gref.GarfSpec()))
def test_leaf_gradient_matches_the_reference(first, leaf):
    (_, grads), (_, grads_r) = first
    g, g_ref = grads[leaf], grads_r[leaf]
    assert g.shape == g_ref.shape and float(g_ref.abs().max()) > 0.0
    assert _rel(g, g_ref) < GRAD_TOL, leaf


@pytest.mark.parametrize("leaf", gref.leaf_names(gref.GarfSpec()))
def test_the_change_over_three_steps_matches_the_reference(run, three, leaf):
    b, _ = run
    state, _, trace = three
    i = gref.leaf_names(b.spec).index(leaf)
    change = float(torch.linalg.norm(state.params.param_list()[i].detach() - b.init[leaf]))
    assert abs(change - trace.change_norms[i]) <= CHANGE_TOL * trace.change_norms[i]


def test_the_corrections_and_losses_over_three_steps_match_the_reference(run, three):
    b, _ = run
    state, losses, trace = three
    change = state.se3_refine - b.state.se3_refine
    assert float(torch.linalg.norm(trace.pose_change)) > 0.0
    assert float(torch.linalg.norm(change - trace.pose_change)
                 / torch.linalg.norm(trace.pose_change)) < POSE_TOL
    for got, want in zip(losses, trace.losses):
        assert abs(got - want) <= STEPS_LOSS_TOL * want


@pytest.mark.parametrize("leaf", gref.leaf_names(gref.GarfSpec()) + ["se3_refine"])
def test_each_step_from_the_ports_state_matches_the_reference(run, each, leaf):
    b, _ = run
    state, losses, trace = each
    assert all(abs(got - want) <= LOSS_TOL * want for got, want in zip(losses, trace.losses))
    if leaf == "se3_refine":
        change = state.se3_refine - b.state.se3_refine
        assert float(torch.linalg.norm(trace.pose_change)) > 0.0
        assert float(torch.linalg.norm(change - trace.pose_change)
                     / torch.linalg.norm(trace.pose_change)) < EACH_TOL
        return
    i = gref.leaf_names(b.spec).index(leaf)
    change = float(torch.linalg.norm(state.params.param_list()[i].detach() - b.init[leaf]))
    assert abs(change - trace.change_norms[i]) <= EACH_TOL * trace.change_norms[i]


def test_the_reference_given_its_own_states_retraces_its_steps(run, three):
    """Each step taken from where the reference's own last step left it
    gives the losses, the changes and the corrections of its three steps
    run through; the states it reports are where each step started."""
    b, draws = run
    _, _, trace = three
    assert all(torch.equal(t, b.init[n]) for n, t in trace.states[0][0].items())
    again = gref.train_steps(b.spec, b.init, b.state.se3_refine, b.images, b.poses, b.intr,
                             [(d.ray_idx, d.depth) for d in draws], STEP, b.nu,
                             states=trace.states)
    assert again.losses == trace.losses and again.change_norms == trace.change_norms
    assert torch.equal(again.pose_change, trace.pose_change)
    assert not torch.equal(trace.states[2][1], trace.states[0][1])


def test_the_limits_see_a_wrong_draw(run, three):
    """One wrong draw (the second step's jitter given to the third) reads far
    outside the limits in the corrections and in the worst leaf's change."""
    b, draws = run
    batches = [(d.ray_idx, d.depth) for d in draws]
    batches[2] = (batches[2][0], batches[1][1])
    wrong = gref.train_steps(b.spec, b.init, b.state.se3_refine, b.images, b.poses, b.intr,
                             batches, STEP, b.nu)
    _, _, trace = three
    assert float(torch.linalg.norm(wrong.pose_change - trace.pose_change)
                 / torch.linalg.norm(trace.pose_change)) > 4 * POSE_TOL
    assert max(abs(w - c) / c for w, c in zip(wrong.change_norms, trace.change_norms)) \
        > 4 * CHANGE_TOL


def test_the_gate_closed_gives_no_pose_gradient_on_either_side(run):
    b, draws = run
    closed = b.spec.start_pose_correct_iter - 1
    state = b.state._replace(step=torch.tensor(closed, dtype=torch.int32))
    _, grads = _port_grads(b, state, draws[0])
    _, grads_r = _ref_grads(b, closed, draws[0])
    assert not grads["se3_refine"].any() and not grads_r["se3_refine"].any()
    assert float(grads["Dense_0.kernel"].abs().max()) > 0.0
    # with the corrections at zero the poses, and so the field's gradients, agree
    assert _rel(grads["Dense_0.kernel"], grads_r["Dense_0.kernel"]) < GRAD_TOL


def test_the_reference_imports_no_jax_and_no_port_module():
    allowed = {"__future__", "dataclasses", "typing", "torch"}
    tree = ast.parse((ROOT / "benchmark" / "reference" / "garf.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert not node.level, node.module
            tops = {node.module.split(".")[0]}
        else:
            continue
        assert tops <= allowed, tops
