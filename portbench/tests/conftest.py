import os
import sys

import pytest
import torch

# the checkout's root, so that ``portbench`` imports however pytest is run
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    # one intra-op thread on the CPU, as the port's own tests keep it
    torch.set_num_threads(1)
