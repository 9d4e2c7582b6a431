"""The traffic generators' laws at a tiny size, on the CPU."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import traffic_gen


def _pmf(alpha: float, vocab: int) -> np.ndarray:
    cdf = traffic_gen.zipf_cdf(alpha, vocab).numpy()
    return np.diff(np.concatenate([[0.0], cdf, [1.0]]))


def test_zipf_keys_follow_the_clipped_zipf_law():
    vocab, alpha, n = 64, 1.2, 400_000
    keys = traffic_gen.zipf_keys((n,), alpha, vocab,
                                 traffic_gen.generator(3, "cpu", 1))
    assert keys.dtype == torch.int32
    assert int(keys.min()) >= 0 and int(keys.max()) == vocab - 1
    got = np.bincount(keys.numpy(), minlength=vocab) / n
    want = _pmf(alpha, vocab)
    sigma = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(got - want) <= 5 * sigma + 1e-12)
    # the clipped mass P(rank >= vocab), with zeta(1.2) by Euler-Maclaurin
    r = np.arange(1, 10**6 + 1, dtype=np.float64)
    N = r[-1]
    zeta = (r ** -alpha).sum() + N ** (1 - alpha) / (alpha - 1) \
        - N ** -alpha / 2
    tail = 1 - (r[:vocab - 1] ** -alpha).sum() / zeta
    assert abs(want[-1] - tail) < 1e-9


def test_zipf_keys_match_the_programs_numpy_stream():
    """The same law as ``data.pipeline.TurnstileZipfStream`` draws with
    numpy's ``zipf``, to sampling error."""
    from repro_torch.data.pipeline import TurnstileZipfStream

    vocab, n = 1 << 12, 200_000
    stream = TurnstileZipfStream(vocab_size=vocab, alpha=1.2, seed=5)
    theirs = np.concatenate([stream._inserts(t, 0, 20_000)
                             for t in range(10)])
    ours = traffic_gen.zipf_keys((n,), 1.2, vocab,
                                 traffic_gen.generator(9, "cpu", 1)).numpy()
    grid = np.arange(vocab)
    cdf_a = np.searchsorted(np.sort(theirs), grid, side="right") / n
    cdf_b = np.searchsorted(np.sort(ours), grid, side="right") / n
    assert np.abs(cdf_a - cdf_b).max() < 0.01  # KS, ~6x its noise


def test_turnstile_pool_retracts_after_inserting():
    pool = traffic_gen.zipf_turnstile_pool(5, 64, 0.25, 1.2, 1024, 4, 11,
                                           "cpu")
    P, B, n = pool.keys.shape
    assert (P, B, n) == (4, 5, 80)
    ins = pool.keys[:, :, :64]
    for j in range(P):
        assert torch.equal(pool.keys[j, :, 64:], ins[j - 1, :, :16])
    assert bool((pool.values[:, :, :64] == 1).all())
    assert bool((pool.values[:, :, 64:] == -1).all())
    assert torch.equal(pool.prime_keys[:, :64], ins[-1])
    assert bool((pool.prime_keys[:, 64:] == -1).all())
    assert bool((pool.prime_values[:, 64:] == 0).all())
    # replayed from the priming batch, no key's count ever goes negative
    freq = torch.zeros((B, 1024))
    batches = [(pool.prime_keys, pool.prime_values)] + [
        (pool.keys[j % P], pool.values[j % P]) for j in range(2 * P)]
    for keys, vals in batches:
        ok = keys != -1
        for b in range(B):
            freq[b].index_add_(0, keys[b][ok[b]].long(), vals[b][ok[b]])
        assert float(freq.min()) >= 0


def test_pools_are_a_function_of_the_seed():
    big = 2**31 + 987_654_321
    a = traffic_gen.zipf_turnstile_pool(3, 32, 0.25, 1.2, 512, 2, big, "cpu")
    b = traffic_gen.zipf_turnstile_pool(3, 32, 0.25, 1.2, 512, 2, big, "cpu")
    c = traffic_gen.zipf_turnstile_pool(3, 32, 0.25, 1.2, 512, 2, big + 1,
                                        "cpu")
    assert torch.equal(a.keys, b.keys)
    assert not torch.equal(a.keys, c.keys)
    g1 = traffic_gen.gradient_pool([10, 30], 1.5, 2, big, "cpu")
    assert torch.equal(g1, traffic_gen.gradient_pool([10, 30], 1.5, 2, big,
                                                     "cpu"))


def test_gradient_pool_scales_each_coordinate():
    sizes, steps = [300, 2000], 256
    pool = traffic_gen.gradient_pool(sizes, 1.5, steps, 4, "cpu")
    assert pool.shape == (steps, 2, 2000)
    assert bool((pool[:, 0, 300:] == 0).all())
    # each coordinate is its fixed scale times N(0, 1) noise: the log of
    # its spread over the steps is N(0, 1.5**2) across coordinates
    log_sd = torch.log(pool[:, 1, :].std(0))
    assert abs(float(log_sd.mean())) < 0.15
    assert abs(float(log_sd.std()) - 1.5) < 0.1
