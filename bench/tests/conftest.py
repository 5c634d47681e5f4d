"""The benchmark's own tests: ``python -m pytest bench/tests`` from the root
of the checkout.  Tests marked ``cuda`` need the card and skip elsewhere."""

from __future__ import annotations

import pytest
import torch

from tiny import load_run


@pytest.fixture(scope="session")
def bench_run():
    return load_run()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
