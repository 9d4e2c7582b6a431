"""Paper Figure 1: WOR vs WR -- effective sample size + tail estimation
(the port's counterpart of ``benchmarks/fig1_wor_vs_wr.py``).

Left/middle panels: effective (distinct-key) sample size vs actual sample
size for Zipf[1] and Zipf[2].  Right panel proxy: NRMSE of the tail mass
estimate (sum of frequencies below the top-100) from ell_2 samples.  The
WOR samples are the reference's key for key; the WR draws come from a
``torch.Generator`` seeded per draw (the reference's from a JAX PRNG key),
so the WR numbers agree in distribution only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import estimators, perfect
from repro_torch.core.device import resolve_device

from .common import synchronize, zipf_freqs


def tail_mass_wor(freqs, k, p, seed_t, top, device) -> float:
    """The HT estimate of the mass outside the ``top`` keys from one
    p-ppswor sample."""
    f = torch.as_tensor(freqs, device=device)
    s = perfect.ppswor_sample(f, k, p, seed_t)
    in_tail = ~torch.isin(s.keys, torch.as_tensor(top, device=device))
    probs = estimators.inclusion_probability(s.freqs, s.threshold, p)
    return float(torch.sum(torch.where(
        in_tail, torch.abs(s.freqs) / torch.clamp(probs, min=1e-30), 0.0)))


def run(n: int = 10_000, verbose: bool = True, device=None):
    dev = resolve_device(device)
    rows = []
    for alpha in (1.0, 2.0):
        freqs = zipf_freqs(n, alpha, seed=int(alpha))
        f = torch.as_tensor(freqs, device=dev)
        for k in (10, 100, 1000):
            t0 = time.perf_counter()
            eff = []
            for t in range(10):
                draws = perfect.wr_sample(
                    f, k, 2.0, torch.Generator(dev).manual_seed(t))
                eff.append(len(np.unique(draws.cpu().numpy())))
            synchronize(dev)
            us = (time.perf_counter() - t0) * 1e6 / 10
            rows.append((f"fig1_effsize_zipf{alpha:g}_k{k}", us,
                         f"wr_effective={np.mean(eff):.1f} wor_effective={k}"))
            if verbose:
                print(rows[-1])

    # tail-mass estimation (right panel proxy), ell_2 samples, Zipf[2]
    freqs = zipf_freqs(n, 2.0, seed=2)
    f = torch.as_tensor(freqs, device=dev)
    order = np.argsort(-np.abs(freqs))
    tail_keys = order[100:]
    truth = float(np.abs(freqs[tail_keys]).sum())
    k = 100
    wor_est, wr_est = [], []
    t0 = time.perf_counter()
    for t in range(30):
        wor_est.append(tail_mass_wor(freqs, k, 2.0, 7000 + t, order[:100],
                                     dev))
        draws = perfect.wr_sample(
            f, k, 2.0, torch.Generator(dev).manual_seed(50 + t)).cpu().numpy()
        w = np.abs(freqs).astype(np.float64)
        p2 = w ** 2 / (w ** 2).sum()
        contrib = np.where(np.isin(draws, tail_keys),
                           w[draws] / (k * p2[draws]), 0.0)
        wr_est.append(float(contrib.sum()))
    synchronize(dev)
    us = (time.perf_counter() - t0) * 1e6 / 30
    nr_wor = estimators.nrmse(np.array(wor_est), truth)
    nr_wr = estimators.nrmse(np.array(wr_est), truth)
    rows.append(("fig1_tailmass_zipf2_l2", us,
                 f"wor_nrmse={nr_wor:.3e} wr_nrmse={nr_wr:.3e}"))
    if verbose:
        print(rows[-1])
    return rows


if __name__ == "__main__":
    run()
