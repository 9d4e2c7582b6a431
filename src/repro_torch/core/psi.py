"""Psi calibration: sketch-width parameter from Theorem 3.1 / Appendix B.1.

Psi_{n,k,rho}(delta) is the largest psi such that, for ANY input frequencies
and ANY conditioning on the order of the transformed vector, the top-k of
nu* ~ p-ppswor[nu] are ell_q (k, psi) residual heavy hitters w.p. >= 1-delta.

The paper shows (Lemma C.1) that the rHH ratio statistic is dominated by the
universal distribution

    R_{n,k,rho} = sum_{i=k+1..n} (S_k / S_i)^rho,   S_i = Z_1+..+Z_i, Z~Exp[1]

so Psi(delta) = k / quantile_{1-delta}(R_{n,k,rho}).  Appendix B.1 calibrates
by simulation; we do the same (vectorized), plus expose the closed-form
Theorem 3.1 lower bounds.

numpy float64 throughout, as in the reference, so the port's values equal
``repro.core.psi``'s bit for bit from the same seed.
"""
from __future__ import annotations

import functools

import numpy as np


def simulate_R(
    n: int, k: int, rho: float, num_samples: int = 500, seed: int = 0
) -> np.ndarray:
    """Draw ``num_samples`` i.i.d. samples of R_{n,k,rho} (Definition B.1)."""
    if not 1 <= k < n:
        raise ValueError("need 1 <= k < n")
    rng = np.random.default_rng(seed)
    out = np.empty((num_samples,), np.float64)
    # Chunk to bound memory for large n * num_samples.
    chunk = max(1, int(2e7 // n))
    for lo in range(0, num_samples, chunk):
        hi = min(num_samples, lo + chunk)
        z = rng.exponential(size=(hi - lo, n))
        s = np.cumsum(z, axis=1)
        sk = s[:, k - 1 : k]  # S_k
        ratios = (sk / s[:, k:]) ** rho  # terms i = k+1 .. n
        out[lo:hi] = ratios.sum(axis=1)
    return out


def psi_from_simulation(
    n: int,
    k: int,
    rho: float,
    delta: float = 0.01,
    num_samples: int = 500,
    seed: int = 0,
) -> float:
    """Appendix B.1: Psi ~= k / empirical (1-delta)-quantile of R_{n,k,rho}."""
    r = simulate_R(n, k, rho, num_samples, seed)
    q = float(np.quantile(r, 1.0 - delta))
    return k / q


def psi_lower_bound(n: int, k: int, rho: float, C: float = 2.0) -> float:
    """Theorem 3.1 closed form (with the simulation-calibrated constant C).

    rho = 1: Psi >= 1 / (C ln(n/k));  rho > 1: Psi >= max(rho-1, 1/ln(n/k)) / C.
    """
    ln_nk = max(np.log(max(n / max(k, 1), np.e)), 1e-9)
    if rho <= 1.0:
        return 1.0 / (C * ln_nk)
    return max(rho - 1.0, 1.0 / ln_nk) / C


def rhh_width(
    n: int,
    k: int,
    rho: float,
    delta: float = 0.01,
    epsilon: float = 1.0 / 3.0,
    calibrate: bool = False,
    num_samples: int = 500,
) -> int:
    """CountSketch width for an ell_q (k+1, psi)-rHH sketch with
    psi = epsilon^q * Psi (paper Sec. 4 uses epsilon=1/3, Sec. 5 epsilon<=1/3).

    Table 1: width = O(k / psi).  ``calibrate=True`` runs the App. B.1
    simulation; otherwise uses the Theorem 3.1 closed form with C=2 (the paper
    reports C < 2 suffices for delta=0.01, rho in {1,2}, k >= 10).
    """
    if calibrate:
        psi = psi_from_simulation(n, k, rho, delta, num_samples)
    else:
        psi = psi_lower_bound(n, k, rho)
    psi_eff = (epsilon ** rho) * psi if rho > 0 else epsilon * psi
    return int(np.ceil((k + 1) / max(psi_eff, 1e-12)))


@functools.lru_cache(maxsize=None)
def paper_width(k: int) -> int:
    """The fixed practical size the paper's own experiments use: k x 31."""
    return 31 * k
