"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark's
data files, and one torch thread a test (the suite runs several workers on
one host, where torch's threads would spin against each other)."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make(tmp_path)
