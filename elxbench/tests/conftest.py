"""Shared fixtures of the benchmark's own tests (CPU; the `cuda`-marked
ones skip without a card). Run from the root of the repository:

    python -m pytest elxbench/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures only there")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
