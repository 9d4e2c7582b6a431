"""Inverse-probability (Horvitz-Thompson) estimators over bottom-k samples.

Paper Eq. (1): for a bottom-k sample S with threshold tau,
    f(w_x)-hat = f(w_x) / Pr_{r~D}[ r <= (|w_x| / tau)^p ]      if x in S
(0 otherwise).  For p-ppswor, D = Exp[1], so the inclusion probability is
    p_x = 1 - exp( -(|nu_x| / tau)^p );
for p-priority, D = U[0,1]: p_x = min(1, (|nu_x| / tau)^p).

One-pass WORp (Eq. 17) plugs the estimated frequency nu'_x and the
estimated threshold into the same formula; Theorem 5.1 bounds the bias and
MSE.  Samples may carry leading batch axes: a (..., k) ``freqs`` takes a
(...) threshold per sample.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import transforms
from .perfect import Sample


def inclusion_probability(freqs: torch.Tensor, tau, p: float,
                          scheme: str = transforms.PPSWOR) -> torch.Tensor:
    """Pr[key in sample] of each key of frequency ``freqs`` at threshold
    ``tau`` (one per sample of a batch: (...) against (..., k) freqs)."""
    freqs = freqs.to(torch.float32)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=freqs.device)
    if tau.dim() == freqs.dim() - 1:
        tau = tau[..., None]
    ratio = (freqs.abs() / tau) ** float(p)
    if scheme == transforms.PPSWOR:
        # expm1 keeps precision in the p_x -> 0 limit
        return -torch.expm1(-ratio)
    if scheme == transforms.PRIORITY:
        return torch.clamp(ratio, max=1.0)
    raise ValueError(scheme)


def per_key_estimates(sample: Sample, p: float,
                      f: Callable[[torch.Tensor], torch.Tensor],
                      scheme: str = transforms.PPSWOR) -> torch.Tensor:
    """f(nu_x)-hat for each sampled key (Eq. 1 / Eq. 17): unbiased for an
    exact sample (two-pass, perfect); a one-pass sample takes the same path
    with its estimated frequencies and threshold."""
    probs = inclusion_probability(sample.freqs, sample.threshold, p, scheme)
    return f(sample.freqs) / torch.clamp(probs, min=1e-30)


def sum_statistic(sample: Sample, p: float,
                  f: Callable[[torch.Tensor], torch.Tensor],
                  L: torch.Tensor | None = None,
                  scheme: str = transforms.PPSWOR) -> torch.Tensor:
    """Unbiased estimate of sum_x f(nu_x) L_x (Eq. 2); ``L`` are optional
    per-sampled-key selection values (default 1)."""
    est = per_key_estimates(sample, p, f, scheme)
    if L is not None:
        est = est * L
    return est.sum()


def frequency_moment(sample: Sample, p: float, power: float,
                     scheme: str = transforms.PPSWOR) -> torch.Tensor:
    """||nu||_{p'}^{p'} estimate from an ell_p sample (paper Table 3)."""
    return sum_statistic(sample, p, lambda w: w.abs() ** power, None, scheme)


def rank_frequency_estimate(sample: Sample, p: float,
                            scheme: str = transforms.PPSWOR):
    """Paper Fig. 2: (|nu| sorted in decreasing order, HT weights): each
    sampled key stands for 1/p_x keys of its frequency; cumulative weights
    give estimated ranks.  Ties keep sample order (a stable sort)."""
    probs = inclusion_probability(sample.freqs, sample.threshold, p, scheme)
    mag = sample.freqs.abs()
    order = torch.argsort(-mag, stable=True)
    return mag[order], (1.0 / torch.clamp(probs, min=1e-30))[order]


def nrmse(estimates, truth: float) -> float:
    """Normalized root mean squared error over repeated runs (Table 3)."""
    e = np.asarray(estimates, np.float64)
    return float(np.sqrt(np.mean((e - truth) ** 2)) / abs(truth))
