"""The benchmark's CPU tests: the harness at a tiny size with the program's
plain kernel versions. Run from the repository's root:

    python -m pytest slambench/tests -q

Tests marked `cuda` run the control on the card at the cells' own size and
skip where there is none."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cells' own "
                    "size with the hand-written kernels")
    return torch.device("cuda")
