"""A run whose timed path is broken underneath reads ``correct`` false, for
each fault the cells can have: a step that leaves its state unchanged, half
of the batch left out (the mean over the rest), a rendered answer altered
where it is produced. (No cell spans chips, so no exchange can be left
out.) The runs are the cells at a small size on the CPU, with the cells'
own limits."""
import time

import pytest
import torch

from benchmark.lib import harness
from benchmark.tests.sizes import TINY
from conftest import ROOT


def _run(name):
    return harness.run_cell(ROOT, name, 1234, 0.0, False, "cpu", time.perf_counter(),
                            TINY[name])


def _ngp_unchanged(monkeypatch):
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainer

    def update(self, grads):
        self.state = self.state._replace(step=self.state.step + 1)
        return None

    monkeypatch.setattr(NGPTrainer, "update", update)


def _ngp_half_batch(monkeypatch):
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainer

    forward = NGPTrainer.forward

    def half(self, rays_o, rays_d, target, bg, xi):
        _, out = forward(self, rays_o, rays_d, target, bg, xi)
        n = target.shape[0] // 2
        return self.loss_fn(out.rgb[:n], target[:n]).mean(), out

    monkeypatch.setattr(NGPTrainer, "forward", half)


def _ngp_altered_frame(monkeypatch):
    from myc_nerfs_tpu_torch.train.ngp_trainer import NGPTrainer

    render = NGPTrainer.render_image

    def altered(self, *args, **kwargs):
        rgb, depth = render(self, *args, **kwargs)
        rgb = rgb.clone()
        rgb[::2] += 0.05
        return rgb, depth

    monkeypatch.setattr(NGPTrainer, "render_image", altered)


def _tensorf_unchanged(monkeypatch):
    """The step runs its loss and backward; the Adam update returns no
    change and its state as it was."""
    from myc_nerfs_tpu_torch.train import tensorf_trainer

    def adam_step(sched, betas, eps, grads, state):
        return [torch.zeros_like(g) for g in grads], state

    monkeypatch.setattr(tensorf_trainer, "adam_step", adam_step)


def _tensorf_half_batch(monkeypatch):
    from myc_nerfs_tpu_torch.train.tensorf_trainer import TensoRFTrainer

    loss = TensoRFTrainer.loss

    def half(self, rays, rgbs, draws, params=None, step=None):
        n = rays.shape[0] // 2
        return loss(self, rays[:n], rgbs[:n], draws[:n], params, step)

    monkeypatch.setattr(TensoRFTrainer, "loss", half)


@pytest.mark.parametrize("name,fault", [
    ("ngp_car.train", _ngp_unchanged),
    ("ngp_car.train", _ngp_half_batch),
    ("ngp_car.render", _ngp_altered_frame),
    ("tensorf_coffee.train", _tensorf_unchanged),
    ("tensorf_coffee.train", _tensorf_half_batch),
])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(name)
    assert line["correct"] is False, line["checks"]
