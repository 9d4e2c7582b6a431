"""Shared test fixtures + test-tier marker registration.

Tiers (see also pytest.ini, whose addopts deselect the slow tiers):
  * unmarked       -- tier-1: fast, runs on every push (`pytest -q`).
  * @pytest.mark.deep  -- full statistical-conformance / kernel grids with
    large Monte-Carlo trial counts; nightly CI (`pytest -m deep`).
  * @pytest.mark.bench -- benchmark-style timing tests; opt-in only.
  * @pytest.mark.chaos -- multi-process fleet fault-injection suite
    (process spawns + scripted kill/hang/delay faults; seed-matrixed in
    CI via FLEET_CHAOS_SEED, `pytest -m chaos`).

NOTE: no XLA_FLAGS here on purpose -- smoke tests and benches must see the
single real CPU device; only launch/dryrun.py requests 512 host devices.
"""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "deep: full conformance/kernel grids with large trial counts "
        "(nightly; deselected from tier-1 by pytest.ini addopts)")
    config.addinivalue_line(
        "markers",
        "bench: benchmark-style timing tests (opt-in; deselected from "
        "tier-1 by pytest.ini addopts)")
    config.addinivalue_line(
        "markers",
        "chaos: multi-process fleet fault-injection tests (slow process "
        "spawns; seed-matrixed in CI, deselected from tier-1 by "
        "pytest.ini addopts)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels); skips inside the test "
        "body when none is present")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def zipf_freqs(n: int, alpha: float, seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-like frequency vector: freq(rank r) ~ r^-alpha."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    f = ranks ** (-alpha) * n
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return f[perm].astype(np.float32)
