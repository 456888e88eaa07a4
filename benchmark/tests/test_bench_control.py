"""The control of each cell fails its check: the reference in the nearest
precision below the configuration's (float8 for the bf16 NGP cells, TF32
products for the f32 TensoRF cell), put in the program's place, reads past
at least one limit. On the card only, at the cells' own sizes, one seed
each: ``python -m pytest -m cuda benchmark/tests/test_bench_control.py``."""
import pytest

from benchmark import control
from benchmark.lib import catalog
from conftest import ROOT

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in catalog.load(ROOT)["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(cuda_device, name):
    limits = catalog.limits(ROOT, name)
    readings = control.control_side(name, 9001, cuda_device)
    assert any(readings[k] > limits[k] for k in limits), (readings, limits)
