"""The benchmark's own tests: ``python -m pytest gpbench/tests -o
addopts="" -p no:cacheprovider`` from the repository root.  Tests marked
``cuda`` skip without a card; on the card they run with the same
command."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
