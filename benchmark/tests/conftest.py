"""Shared settings of the benchmark's tests: the import path, few threads,
and the card fixture of the tests marked ``cuda``.

Run them from the root of the repository: ``python -m pytest benchmark/tests``
(on a CUDA machine add ``-m cuda`` for the ones that need the card).
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)
