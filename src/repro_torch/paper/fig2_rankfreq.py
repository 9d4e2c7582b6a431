"""Paper Figure 2: rank-frequency distribution estimates (the port's
counterpart of ``benchmarks/fig2_rankfreq.py``).

From one (representative) sample of size k=100: the estimated frequency at
selected true ranks, for WORp 1-pass / 2-pass / perfect WOR (shared
randomization).  Reported as relative error at rank buckets.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import estimators, perfect, worp
from repro_torch.core.device import resolve_device

from .common import one_pass_state, synchronize, two_pass_sample, zipf_freqs

PROBE = [1, 3, 10, 30, 100, 300, 1000]


def rank_curve(sample, p):
    mags, wts = estimators.rank_frequency_estimate(sample, p)
    ranks = np.cumsum(wts.cpu().numpy())
    return mags.cpu().numpy(), ranks


def err_at_ranks(mags, ranks, true_sorted, probe):
    errs = []
    for r in probe:
        i = np.searchsorted(ranks, r)
        if i >= len(mags):
            errs.append(np.nan)
            continue
        est, true = mags[i], true_sorted[r - 1]
        errs.append(abs(est - true) / true)
    return np.nanmean(errs)


def run(n: int = 10_000, k: int = 100, verbose: bool = True, device=None,
        errors: dict = None):
    """The three rows; ``errors``, if given, receives each row's relative
    errors by method."""
    dev = resolve_device(device)
    rows = []
    for (p, alpha) in [(2.0, 1.0), (2.0, 2.0), (1.0, 2.0)]:
        freqs = zipf_freqs(n, alpha, seed=31)
        true_sorted = np.sort(np.abs(freqs))[::-1]
        seed_t = 424242
        t0 = time.perf_counter()
        s_wor = perfect.ppswor_sample(torch.as_tensor(freqs, device=dev), k,
                                      p, seed_t)
        s_one = worp.onepass_sample(
            one_pass_state(freqs, k, p, seed_t, device=dev), k, p)
        s_two = two_pass_sample(freqs, k, p, seed_t, device=dev)
        synchronize(dev)
        us = (time.perf_counter() - t0) * 1e6
        errs = {}
        for name, s in [("wor", s_wor), ("one", s_one), ("two", s_two)]:
            mags, ranks = rank_curve(s, p)
            errs[name] = err_at_ranks(mags, ranks, true_sorted, PROBE)
        if errors is not None:
            errors[(p, alpha)] = errs
        rows.append((f"fig2_rankfreq_l{p:g}_zipf{alpha:g}", us,
                     f"relerr wor={errs['wor']:.3f} one={errs['one']:.3f} "
                     f"two={errs['two']:.3f}"))
        if verbose:
            print(rows[-1])
    return rows


if __name__ == "__main__":
    run()
