"""Port parity of the rest of ``core/``: ``estimators``, ``counters``,
``psi``, ``countsketch.sketch_vector`` and ``estimate_single_row``.  The
same numpy inputs go through the JAX module and the port's.

Tolerances: psi is numpy float64 in both, so bit for bit; counter keys bit
for bit and counts within rtol 1e-6 (the same sums of float32 counts, in
sorted order in both); estimators within rtol 1e-5 (float32 ``pow`` and
``expm1`` of two libraries); sketch tables within the kernels' scale-aware
bound, rtol 1e-4 / atol 1e-5 * max(1, max|want|) (float32 sums in either
package's order), and single-row reads of the same table bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as jcounters
from repro.core import countsketch as jcs
from repro.core import estimators as jest
from repro.core import perfect as jperfect
from repro.core import psi as jpsi
from repro_torch.core import counters, countsketch, estimators, psi
from repro_torch.core.perfect import Sample

# --------------------------------------------------------------------------
# psi: numpy float64 in both packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,rho,seed", [(500, 10, 1.0, 0), (2000, 50, 2.0, 3),
                                          (300, 299, 0.5, 7)])
def test_psi_simulation_bitwise(n, k, rho, seed):
    assert np.array_equal(psi.simulate_R(n, k, rho, 64, seed),
                          jpsi.simulate_R(n, k, rho, 64, seed))
    assert psi.psi_from_simulation(n, k, rho, 0.05, 64, seed) \
        == jpsi.psi_from_simulation(n, k, rho, 0.05, 64, seed)


@pytest.mark.parametrize("rho", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("calibrate", [False, True])
def test_psi_widths_bitwise(rho, calibrate):
    for n, k in ((10_000, 50), (1_000, 999), (50, 100)):
        assert psi.psi_lower_bound(n, k, rho) \
            == jpsi.psi_lower_bound(n, k, rho)
        if k < n:
            assert psi.rhh_width(n, k, rho, calibrate=calibrate,
                                 num_samples=32) \
                == jpsi.rhh_width(n, k, rho, calibrate=calibrate,
                                  num_samples=32)
    assert psi.paper_width(100) == jpsi.paper_width(100) == 3100
    with pytest.raises(ValueError, match="1 <= k < n"):
        psi.simulate_R(10, 10, rho)


# --------------------------------------------------------------------------
# estimators
# --------------------------------------------------------------------------

def _samples(seed, k=12, batch=()):
    rng = np.random.default_rng(seed)
    freqs = (rng.pareto(1.5, batch + (k,)) + 0.1).astype(np.float32)
    freqs *= rng.choice([-1.0, 1.0], freqs.shape).astype(np.float32)
    tau = (np.abs(freqs).min(-1) * 0.7).astype(np.float32)
    keys = rng.integers(0, 1000, batch + (k,)).astype(np.int32)
    trans = freqs * 2.0
    t = Sample(keys=torch.tensor(keys), freqs=torch.tensor(freqs),
               threshold=torch.tensor(tau), transformed=torch.tensor(trans))
    j = jperfect.Sample(keys=jnp.asarray(keys), freqs=jnp.asarray(freqs),
                        threshold=jnp.asarray(tau),
                        transformed=jnp.asarray(trans))
    return t, j


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
def test_estimators_match_reference(p, scheme):
    t, j = _samples(int(p * 10) + len(scheme))
    _close(estimators.inclusion_probability(t.freqs, t.threshold, p, scheme),
           jest.inclusion_probability(j.freqs, j.threshold, p, scheme))
    _close(estimators.per_key_estimates(t, p, lambda w: w.abs(), scheme),
           jest.per_key_estimates(j, p, lambda w: jnp.abs(w), scheme))
    _close(estimators.sum_statistic(t, p, lambda w: w ** 2,
                                    L=t.freqs.sign(), scheme=scheme),
           jest.sum_statistic(j, p, lambda w: w ** 2, L=jnp.sign(j.freqs),
                              scheme=scheme))
    for power in (0.0, 1.0, 2.0):
        _close(estimators.frequency_moment(t, p, power, scheme),
               jest.frequency_moment(j, p, power, scheme))
    mags, wts = estimators.rank_frequency_estimate(t, p, scheme)
    jm, jw = jest.rank_frequency_estimate(j, p, scheme)
    assert np.array_equal(mags.numpy(), np.asarray(jm))
    _close(wts, jw)


def test_estimators_batched_thresholds_and_limits():
    """A (T, k) sample with its (T,) thresholds broadcasts per trial, as
    the reference's trial runners use it; the p_x -> 0 and -> 1 limits."""
    t, j = _samples(5, batch=(4,))
    _close(estimators.inclusion_probability(t.freqs, t.threshold, 1.0),
           jest.inclusion_probability(j.freqs, j.threshold, 1.0))
    lim = estimators.inclusion_probability(torch.tensor([1e-6, 1e6]), 1.0,
                                           1.0)
    assert 0 < float(lim[0]) < 1e-5 and float(lim[1]) == 1.0
    assert estimators.nrmse([1.0, 3.0], 2.0) == jest.nrmse([1.0, 3.0], 2.0)
    with pytest.raises(ValueError):
        estimators.inclusion_probability(t.freqs, t.threshold, 1.0, "nope")


# --------------------------------------------------------------------------
# counters
# --------------------------------------------------------------------------

def _assert_counters(got, want):
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("capacity,domain", [(8, 30), (32, 200), (64, 50)])
def test_counters_match_reference(capacity, domain):
    rng = np.random.default_rng(capacity + domain)
    got, want = counters.init(capacity, device="cpu"), \
        jcounters.init(capacity)
    halves = []
    for step in range(6):
        keys = np.minimum(rng.zipf(1.3, 70) - 1, domain - 1).astype(np.int32)
        keys[::9] = -1  # padding slots
        vals = (rng.random(70) * 4 + 0.25).astype(np.float32)
        got = counters.update(got, keys, vals)
        want = jcounters.update(want, jnp.asarray(keys), jnp.asarray(vals))
        _assert_counters(got, want)
        halves.append((got, want))
    merged = counters.merge(halves[1][0], halves[4][0])
    jmerged = jcounters.merge(halves[1][1], halves[4][1])
    _assert_counters(merged, jmerged)
    q = np.arange(-1, domain, dtype=np.int32)
    np.testing.assert_allclose(counters.estimate(got, q).numpy(),
                               np.asarray(jcounters.estimate(
                                   want, jnp.asarray(q))), rtol=1e-6, atol=0)
    for a, b in zip(counters.stored(got), jcounters.stored(want)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_counters_aggregate_batch_sums_in_key_order():
    keys = np.array([5, -1, 3, 5, 3, 3, 9], np.int32)
    vals = np.array([1, 100, 2, 4, 8, 16, 32], np.float32)
    uk, us = counters._aggregate_batch(torch.tensor(keys), torch.tensor(vals))
    juk, jus = jcounters._aggregate_batch(jnp.asarray(keys),
                                          jnp.asarray(vals))
    assert np.array_equal(uk.numpy(), np.asarray(juk))
    assert np.array_equal(us.numpy(), np.asarray(jus))
    assert sorted(zip(uk.tolist(), us.tolist()))[-4:] == [
        (-1, 100.0), (3, 26.0), (5, 5.0), (9, 32.0)]


def test_counters_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        counters.init(4)


# --------------------------------------------------------------------------
# countsketch.sketch_vector / estimate_single_row
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,width,n,seed", [(5, 64, 300, 123),
                                                (7, 50, 1000, 2**32 - 7),
                                                (1, 32, 40, 9)])
def test_sketch_vector_and_single_row_match_reference(rows, width, n, seed):
    rng = np.random.default_rng(n)
    vec = (rng.pareto(1.2, n) * rng.choice([-1, 1], n)).astype(np.float32)
    got = countsketch.sketch_vector(torch.tensor(vec), rows, width, seed)
    want = jcs.sketch_vector(jnp.asarray(vec), rows, width, np.uint32(seed))
    w = np.asarray(want.table)
    np.testing.assert_allclose(got.table.numpy(), w, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(w).max())))
    assert got.seed.item() == seed
    # single-row reads of the SAME table (the reference's, carried over)
    same = countsketch.CountSketch(table=torch.tensor(w), seed=got.seed)
    keys = rng.integers(0, 2 * n, 64).astype(np.int32)
    for r in range(rows):
        assert np.array_equal(
            countsketch.estimate_single_row(same, torch.tensor(keys),
                                            r).numpy(),
            np.asarray(jcs.estimate_single_row(want, jnp.asarray(keys), r)))


def test_sketch_vector_batched_and_unbiased_rows():
    """Leading batch axes sketch each vector with its own seed, as one
    call per vector does; a row's read of a lone key is its value."""
    rng = np.random.default_rng(1)
    vecs = torch.tensor(rng.normal(size=(3, 200)).astype(np.float32))
    seeds = torch.tensor([1, 2, 3])
    both = countsketch.sketch_vector(vecs, 4, 64, seeds)
    for b in range(3):
        one = countsketch.sketch_vector(vecs[b], 4, 64, int(seeds[b]))
        assert torch.equal(both.table[b], one.table)
    lone = torch.zeros(100)
    lone[42] = 3.5
    sk = countsketch.sketch_vector(lone, 3, 16, 5)
    for r in range(3):
        assert float(countsketch.estimate_single_row(
            sk, torch.tensor([42]), r)[0]) == 3.5
