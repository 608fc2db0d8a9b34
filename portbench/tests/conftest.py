"""The ``cuda`` marker's fixture (decided at run time, never at import)."""

import pytest


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
