"""Tests of the port's kernels that need an NVIDIA GPU (run on the card:
``python -m pytest tests_cuda -q``). Each test takes the ``cuda`` fixture,
which skips when no GPU is present; whether there is one is decided there,
never at import time."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    # fp32 results are compared: no TF32
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
