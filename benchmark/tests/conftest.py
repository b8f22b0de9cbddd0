"""The benchmark's CPU tests: the harness, the yardstick and the plain
reference at tiny sizes (``tiny.py``); tests marked ``cuda`` need the card
and skip without one."""

import os

import pytest
import torch

# one share of the machine's cores per pytest-xdist worker
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, os.cpu_count() // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"
