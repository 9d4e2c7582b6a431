"""Variance-aware acceptance bounds for the conformance harness.

The port's own copy of ``repro.validate.bounds`` (numpy and the standard
library only): every function returns the reference's value bit for bit on
the same inputs.

Every tolerance used by ``repro_torch.validate.conformance`` is DERIVED
here from (trial count, failure probability, sketch geometry) -- never
hand-tuned.
The conventions:

  * ``delta`` is the per-check failure probability budget: a correct sampler
    fails the check with probability <= delta (before fp/approximation
    allowances, which are one-sided and only loosen).
  * ``support`` is the union-bound multiplicity: a check asserting n
    per-key statements splits delta over the n keys.

Bound families:

  binomial / Chernoff     inclusion-frequency tolerances
      ``hoeffding_radius``            distribution-free, O(sqrt(log/T))
      ``bernstein_radius``            empirical-variance (tight for small p)
      ``binomial_radius``             min of the two (both are valid bounds)
      ``two_sample_radius``           |p1_hat - p2_hat| tolerance when BOTH
                                      sides are Monte-Carlo estimates
  CLT / chi-square        estimator-error tolerances
      ``clt_mean_radius``             |mean_T - truth| via Student-t-free
                                      normal quantile on the EMPIRICAL std
      ``chi2_quantile``               Wilson-Hilferty approximation
      ``nrmse_upper_factor``          how far a T-trial NRMSE estimate can
                                      sit above its population value
  KS / DKW                whole-distribution tolerances
      ``dkw_radius``                  sup-norm CDF deviation
      ``two_sample_ks_radius``        two empirical CDFs
  order statistics
      ``sign_test_min_wins``          paired-comparison win count under the
                                      null of no improvement
  sketch geometry
      ``median_flip_bound``           P[CountSketch median estimate crosses
                                      a gap g], from per-row Chebyshev +
                                      Chernoff majority
      ``fp32_nrmse_floor``            accumulation-noise floor for NRMSE
                                      golden-value comparisons
"""
from __future__ import annotations

import math
import statistics

import numpy as np


def normal_quantile(q: float) -> float:
    """z with Phi(z) = q (stdlib inverse CDF; no scipy dependency)."""
    return statistics.NormalDist().inv_cdf(q)


# ---------------------------------------------------------------------------
# binomial / Chernoff: inclusion frequencies
# ---------------------------------------------------------------------------

def hoeffding_radius(trials: int, delta: float, support: int = 1) -> float:
    """r with P[|p_hat - p| > r] <= delta/support for ONE binomial estimate;
    union-bounded over ``support`` simultaneous statements."""
    return math.sqrt(math.log(2.0 * support / delta) / (2.0 * trials))


def bernstein_radius(phat, trials: int, delta: float, support: int = 1):
    """Empirical-Bernstein radius: sqrt(2 v L / T) + 7L/(3(T-1)) with
    v = phat(1-phat) and L = ln(3*support/delta).  Much tighter than
    Hoeffding when phat is near 0 or 1 (the common case for per-key
    inclusion of light keys).  Vectorized over ``phat``."""
    phat = np.asarray(phat, np.float64)
    L = math.log(3.0 * support / delta)
    v = phat * (1.0 - phat)
    return np.sqrt(2.0 * v * L / trials) + 7.0 * L / (3.0 * (trials - 1))


def binomial_radius(phat, trials: int, delta: float, support: int = 1):
    """Per-key binomial tolerance: min(Hoeffding, empirical Bernstein) --
    both hold simultaneously with probability >= 1 - delta/support each, so
    the min is a valid (delta-doubling absorbed into the constants) bound."""
    h = hoeffding_radius(trials, delta, support)
    return np.minimum(bernstein_radius(phat, trials, delta, support), h)


def two_sample_radius(phat1, trials1: int, phat2, trials2: int,
                      delta: float, support: int = 1):
    """Tolerance on |p1_hat - p2_hat| when both sides are empirical: each
    side gets half the failure budget."""
    return (binomial_radius(phat1, trials1, delta / 2.0, support)
            + binomial_radius(phat2, trials2, delta / 2.0, support))


# ---------------------------------------------------------------------------
# CLT / chi-square: estimator error
# ---------------------------------------------------------------------------

def clt_mean_radius(sample_std: float, trials: int, delta: float) -> float:
    """|mean_T - E| tolerance from the CLT with the EMPIRICAL std: z_{1-d/2}
    * s / sqrt(T), inflated by sqrt(T/(T-2)) for the std's own estimation
    error (a light-tailed stand-in for the t quantile; trials >= 8)."""
    z = normal_quantile(1.0 - delta / 2.0)
    infl = math.sqrt(trials / max(trials - 2.0, 1.0))
    return z * infl * sample_std / math.sqrt(trials)


def chi2_quantile(df: int, q: float) -> float:
    """Wilson-Hilferty chi-square quantile approximation (scipy-free)."""
    z = normal_quantile(q)
    c = 2.0 / (9.0 * df)
    return df * (1.0 - c + z * math.sqrt(c)) ** 3


def nrmse_upper_factor(trials: int, delta: float) -> float:
    """Factor F with  NRMSE_hat <= F * NRMSE  w.p. >= 1 - delta (Gaussian
    error model: T * MSE_hat / MSE ~ chi^2_T), used to compare a T-trial
    NRMSE measurement against a golden (population) value."""
    return math.sqrt(chi2_quantile(trials, 1.0 - delta) / trials)


def nrmse_lower_factor(trials: int, delta: float) -> float:
    """Factor f with  NRMSE_hat >= f * NRMSE  w.p. >= 1 - delta."""
    return math.sqrt(max(chi2_quantile(trials, delta), 1e-12) / trials)


# ---------------------------------------------------------------------------
# KS / DKW: whole distributions
# ---------------------------------------------------------------------------

def dkw_radius(trials: int, delta: float) -> float:
    """Dvoretzky-Kiefer-Wolfowitz: sup_x |F_hat - F| tolerance."""
    return math.sqrt(math.log(2.0 / delta) / (2.0 * trials))


def two_sample_ks_radius(trials1: int, trials2: int, delta: float) -> float:
    """sup-norm tolerance between two empirical CDFs (DKW each side)."""
    return dkw_radius(trials1, delta / 2.0) + dkw_radius(trials2, delta / 2.0)


# ---------------------------------------------------------------------------
# order statistics: paired comparisons
# ---------------------------------------------------------------------------

def sign_test_min_wins(trials: int, delta: float) -> int:
    """Minimum number of per-trial wins (out of ``trials`` paired
    comparisons) that refutes the null 'no better than a coin flip' at
    level delta (one-sided Hoeffding)."""
    return int(math.ceil(trials / 2.0
                         + math.sqrt(trials * math.log(1.0 / delta) / 2.0)))


# ---------------------------------------------------------------------------
# sketch geometry: approximation allowances for estimated samplers
# ---------------------------------------------------------------------------

def median_flip_bound(q, rows: int):
    """P[median-of-rows CountSketch estimate deviates by more than g] when
    each row deviates with probability <= q (per-row Chebyshev): the median
    fails only if >= half the rows deviate, bounded by the Chernoff majority
    bound (4q)^{rows/2}.  Vectorized over q."""
    q = np.minimum(np.asarray(q, np.float64), 1.0)
    return np.minimum((4.0 * q) ** (rows / 2.0), 1.0)


def countsketch_flip_probability(tstar, thresholds, width: int, rows: int):
    """Per-key bound on P[sketch noise flips bottom-k inclusion].

    ``tstar``: (T, n) per-trial transformed frequencies (exact, from the
    reference randomization ensemble); ``thresholds``: (T,) the per-trial
    (k+1)-st magnitudes.  A key's inclusion flips only if the estimate
    crosses the gap g = ||nu*_x| - tau|; each CountSketch row errs by more
    than g with probability <= ||nu*||_2^2 / (W g^2) (Chebyshev on the
    bucket-collision variance), and the median needs half the rows to err.
    Returns the (n,) MEAN over trials -- the derived allowance added to the
    binomial tolerance for samplers that sample by ESTIMATED nu*.
    """
    tstar = np.asarray(tstar, np.float64)
    thresholds = np.asarray(thresholds, np.float64)
    mass = np.sum(tstar ** 2, axis=1, keepdims=True)          # (T, 1)
    gap = np.abs(np.abs(tstar) - thresholds[:, None])          # (T, n)
    q = mass / (width * np.maximum(gap, 1e-30) ** 2)           # (T, n)
    return median_flip_bound(q, rows).mean(axis=0)             # (n,)


def sketch_bias_allowance(truth: float, k: int, width: int) -> float:
    """Loose derived bound on the HT-estimate bias of a sampler that plugs
    ESTIMATED frequencies/threshold into Eq. 17: relative bias O(eps) with
    eps = sqrt(k / width) (Theorem 5.1's error scale for a k x (width/k)
    rHH sketch).  Exact samplers get 0."""
    return abs(truth) * math.sqrt(k / width)


def fp32_nrmse_floor(k: int) -> float:
    """NRMSE floor from float32 accumulation over a k-term HT sum: golden
    values below sqrt(k) * 2^-24 are unreachable in fp32 arithmetic."""
    return math.sqrt(k) * 2.0 ** -24


# ---------------------------------------------------------------------------
# wire-codec quantization: derived allowances for lossy comm boundaries
# ---------------------------------------------------------------------------
# A codec (the reference's repro.distributed.codecs; the port's comes with
# its wire codecs) perturbs each decoded float element two ways: a
# SYMMETRIC grid-rounding error of at most ``rel_step * m`` (m = the
# element's scale-slice max-abs), and -- for clamped codecs
# (fp16) -- a ONE-SIDED saturation error of max(|v| - clamp, 0) on the
# element's OWN magnitude.  Everything below derives acceptance widenings
# from those two per-codec constants -- never from observed errors.  The
# split matters: symmetric rounding decorrelates across the randomization
# ensemble (near-zero mean, absorbed by the observed-std CLT radius),
# while saturation and inclusion flips do NOT cancel and need explicit
# bias allowances.  (The naive per-trial worst case sum_sel r_x * step_t
# is avoided on purpose: step_t tracks the ensemble max |nu*|, a
# Pareto(1)-tailed statistic whose trial mean diverges, so any allowance
# built on it saturates the admissibility gate without describing the
# actual estimator error.)

def quantization_step(slice_max, rel_step: float):
    """Symmetric grid-rounding half-width for a slice with max-abs
    ``slice_max``: rel_step * m.  Vectorized over ``slice_max``."""
    return rel_step * np.asarray(slice_max, np.float64)


def _clamp_excess(mag, clamp):
    """One-sided saturation error of each element past a finite clamp."""
    mag = np.asarray(mag, np.float64)
    if clamp is None:
        return np.zeros_like(mag)
    return np.maximum(mag - clamp, 0.0)


def quantization_flip_allowance(tstar, thresholds, rel_step: float,
                                shards: int = 2, clamp=None):
    """Per-key allowance on inclusion-frequency shift from a quantized
    merge, (n,) mean over trials.

    Each of the ``shards`` decoded shard states perturbs a merged
    transformed magnitude by at most ``shards * step_t`` grid error
    (step_t from the per-trial ensemble max m_t = max_x |nu*_x|, the proxy
    for the wire payload's scale-slice max) plus the element's own
    saturation excess.  Both the key's estimate AND the bottom-k threshold
    move within that budget, so inclusion can only flip when the exact gap
    ||nu*_x| - tau| is within the summed perturbation ``pert``.  Grid
    errors are equidistributed within their half-width across the
    randomization ensemble (nu* varies continuously trial to trial), so
    per trial the flip probability is bounded by the uniform tail
    max(0, 1 - gap/pert), not the adversarial 0/1 indicator (a sum of
    independent symmetric uniforms is more concentrated than one uniform
    over the summed support, so the single-uniform tail upper-bounds it).
    The trial mean of that tail bounds the per-key inclusion-frequency
    shift -- the allowance added to the binomial tolerance for codec-axis
    conformance cells.  For the 2-bit control codec pert = 2 * m_t exceeds
    every gap by at least 2x, so each term is > 1/2 and the mean saturates
    past the admissibility gate deterministically.
    """
    tstar = np.asarray(tstar, np.float64)
    thresholds = np.asarray(thresholds, np.float64)
    mag = np.abs(tstar)
    m = np.max(mag, axis=1, keepdims=True)                     # (T, 1)
    step = shards * quantization_step(m, rel_step)             # (T, 1)
    pert = (2.0 * step + shards * _clamp_excess(mag, clamp)
            + shards * _clamp_excess(thresholds[:, None], clamp))
    gap = np.abs(mag - thresholds[:, None])                    # (T, n)
    tail = np.clip(1.0 - gap / np.maximum(pert, 1e-300), 0.0, 1.0)
    return tail.mean(axis=0)                                   # (n,)


def quantization_ht_allowance(freqs, tstar, thresholds, rel_step: float,
                              shards: int = 2, clamp=None,
                              power: float = 1.0) -> float:
    """Systematic (non-cancelling) HT-moment bias bound for a quantized
    merge: clamp saturation + inclusion-flip leakage.

    Symmetric grid rounding contributes (near-)zero MEAN error -- it
    decorrelates across the randomization ensemble and is absorbed by the
    CLT radius on the observed estimator std -- so the bias allowance only
    carries the two one-sided mechanisms:

    * saturation: a selected key clipped at the clamp loses up to
      shards * max(|nu*_x| - clamp, 0) of transformed magnitude; the
      Eq.-(6) inversion r_x = nu_x / |nu*_x| maps that to a frequency
      shift d_nu_x, and a ``power``-moment term moves by (first order)
      power * nu_x^{power-1} * d_nu_x; summed over the trial's selected
      set and averaged over trials.
    * flip leakage: a key whose inclusion flips moves the HT sum by its
      whole per-key term, ~ nu_x^power / pi_x (pi_x the ensemble
      inclusion frequency); weighted by the per-key flip allowance.
    """
    tstar = np.asarray(tstar, np.float64)
    thresholds = np.asarray(thresholds, np.float64)
    freqs = np.abs(np.asarray(freqs, np.float64))
    mag = np.abs(tstar)
    sel = mag >= thresholds[:, None]
    d_nu = (freqs[None, :] / np.maximum(mag, 1e-30)
            * shards * _clamp_excess(mag, clamp))
    clamp_bias = float(np.mean(np.sum(
        sel * power * freqs[None, :] ** (power - 1.0) * d_nu, axis=1)))
    flip = quantization_flip_allowance(tstar, thresholds, rel_step,
                                       shards=shards, clamp=clamp)
    pi = np.maximum(sel.mean(axis=0), 1.0 / tstar.shape[0])
    flip_bias = float(np.sum(flip * freqs ** power / pi))
    return clamp_bias + flip_bias


def quantization_nrmse_allowance(rel_step: float, k: int,
                                 shards: int = 2) -> float:
    """NRMSE widening for a k-term HT sum whose terms each carry up to
    ``shards * rel_step`` relative wire error: sqrt(k) * shards * rel_step,
    the quantization analogue of ``fp32_nrmse_floor`` (composed additively
    with it and the chi2 factors by the golden-value checks)."""
    return math.sqrt(k) * shards * rel_step


def codec_admissible(mean_flip_allowance: float,
                     rel_bias_allowance: float) -> bool:
    """Structural vacuity gate for codec-axis cells: a codec whose derived
    mean flip allowance covers >= 0.5 (half the probability range) or whose
    relative bias allowance reaches 1.0 (100% of the truth) widens the
    tolerances past the point where a pass certifies anything -- the
    harness must reject such a codec rather than rubber-stamp it.  The two
    limits are the saturation points of the quantities themselves, not
    tuned constants."""
    return mean_flip_allowance < 0.5 and rel_bias_allowance < 1.0
