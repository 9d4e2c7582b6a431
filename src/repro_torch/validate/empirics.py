"""Batched repeated-trial runners over the sampler registry (PyTorch).

A *trial* is one full run of a sampler on a fixed frequency vector under a
fresh hash/transform seed pair.  The registry's specs and the engine's
kernel routes take a leading stream axis natively, so T trials are ONE
batched state of T streams: ``derive_trial_seeds`` (the engine's
stream-seed derivation) hands out T independent seed pairs, ``run_trials``
feeds the same data to all T samplers through a DATA PLANE from the port's
plane registry (``repro_torch.engine.planes``) -- the plain ``dense``
reference plane, the scatter-kernel plane (grid name ``"ingest"``, the
registry alias of ``"sparse"``), the double-buffered ``async`` plane and
the per-shard ``pipeline`` plane -- and every downstream statistic --
per-key inclusion counts, HT sum/moment estimates, sample distinctness --
is computed over the leading (T,) axis.  ``PATHS`` is derived from the
plane registry, so a new plane joins the conformance grid without edits
here.

The oracle side (``perfect_trials``) evaluates the exact bottom-k sample of
the TRUE frequency vector for T reference seeds; it also returns the full
per-trial transformed-frequency matrix, which the bounds layer uses to
derive sketch-noise flip allowances for estimated samplers.

Every runner takes ``device`` (the card unless the caller asks otherwise);
statistics come back as numpy arrays, in the reference's dtypes.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import estimators, perfect, transforms
from repro_torch.core.device import resolve_device
from repro_torch.core.sampler import SamplerConfig, SamplerSpec, make_sampler
from repro_torch.engine import engine as eng
from repro_torch.engine import planes

_EMPTY = -1

DENSE = "dense"
INGEST = "ingest"     # grid name of the sparse scatter plane (registry alias)
ASYNC = "async"
# one conformance path per registered plane ("sparse" appears under its
# historical grid name "ingest"; new planes join the grid automatically)
PATHS = tuple(INGEST if name == "sparse" else name
              for name in planes.available_planes())


def zipf_freqs(n: int, alpha: float, seed: int = 0,
               scale: float = 1000.0) -> np.ndarray:
    """Deterministic Zipf[alpha] frequency vector, randomly permuted so key
    id carries no rank information (freq(rank r) ~ r^-alpha)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    f = ranks ** (-alpha)
    f = f / f[0] * scale
    rng = np.random.default_rng(seed)
    return f[rng.permutation(n)].astype(np.float32)


def derive_trial_seeds(trials: int, seed: int, offset: int = 0,
                       device=None):
    """T independent (sketch, transform) seed pairs via the engine's
    stream-seed derivation (block ``offset`` in stream-index units, so
    disjoint offsets give statistically independent trial banks); both
    (T,) int64 tensors of uint32 values on ``device``."""
    cfg = eng.EngineConfig(num_streams=trials, seed=int(seed))
    return eng.derive_stream_seeds(cfg, offset=offset, device=device)


def spec_for(name: str, n: int, k: int, p: float, scheme: str,
             rows: int = 5, width: Optional[int] = None,
             candidates: Optional[int] = None,
             capacity: Optional[int] = None,
             num_samplers: int = 8) -> SamplerSpec:
    """Registry spec at the conformance operating point: the paper's k x 31
    CountSketch geometry (Sec. 7) unless overridden."""
    return make_sampler(name, SamplerConfig(
        rows=rows,
        width=width if width is not None else 31 * k,
        candidates=candidates if candidates is not None else 4 * k,
        capacity=capacity if capacity is not None else 4 * k,
        p=p, scheme=scheme, domain=n, num_samplers=num_samplers))


def run_trials(spec: SamplerSpec, freqs: np.ndarray, k: int, trials: int,
               seed: int, path: str = DENSE, chunks: int = 3,
               offset: int = 0, codec: str = "none", device=None):
    """Run T independent trials of ``spec`` over ``freqs``; returns the
    batched Sample (leading (T,) axis on every leaf) and the final batched
    state, on ``device``.

    ``path`` names a registered data plane (``repro_torch.engine.planes``):
    ``"dense"`` is the spec's plain update, ``"ingest"`` the scatter-kernel
    plane (registry alias of ``"sparse"``; the spec's update for the
    perfect oracle, which holds no sketch), ``"async"`` the double-buffered
    worker-thread plane and ``"pipeline"`` the per-shard plane merged at
    every read -- every plane faces the same distributional acceptance
    bounds.  The stream is split into ``chunks`` element microbatches, each
    dispatched at its own flush boundary (``FlushPolicy(max_elems=1)``
    fires once per ingest), so streaming accumulation is exercised with
    identical dispatch boundaries on every plane.  The sample is drawn
    through the engine's route for the sampler
    (``SketchEngine.sample_state``): the sketch-backed samplers read their
    sketches through the estimate kernel; the others (and an injected spec
    under a name without a route) run the spec.

    ``codec`` names a wire codec forwarded to the plane; the port's planes
    take only ``"none"`` until the codecs are ported.
    """
    if path not in PATHS:
        raise ValueError(f"unknown trial path {path!r}; expected {PATHS}")
    n = int(np.shape(freqs)[0])
    # writable copies: a broadcast view is read-only
    keys = np.tile(np.arange(n, dtype=np.int32), (trials, 1))
    vals = np.tile(np.asarray(freqs, np.float32), (trials, 1))
    sk_seeds, t_seeds = derive_trial_seeds(trials, seed, offset=offset,
                                           device=device)
    plane = planes.make_plane(path, spec, spec.init(sk_seeds, t_seeds),
                              policy=planes.FlushPolicy(max_elems=1),
                              codec=codec)
    try:
        step = -(-n // chunks)
        for lo in range(0, n, step):
            plane.ingest(keys[:, lo:lo + step], vals[:, lo:lo + step])
        plane.drain()
        st = plane.state
    finally:
        plane.close()  # trial planes are throwaway: release worker threads
    route = eng._SAMPLES.get(spec.name)
    if route is None:
        return spec.sample(st, k), st
    return route(st, k, spec.cfg.p, spec.cfg.scheme), st


def perfect_trials(freqs: np.ndarray, k: int, p: float, scheme: str,
                   trials: int, seed: int, offset: int = 0, device=None):
    """Exact bottom-k oracle over T reference seeds, batched.

    Returns (batched Sample, tstar, thresholds): ``tstar`` is the (T, n)
    float32 matrix of exact transformed frequencies nu* per trial -- the
    randomization ensemble itself -- and ``thresholds`` the (T,) (k+1)-st
    magnitudes, both numpy, consumed by the sketch-noise allowance bounds.
    """
    device = resolve_device(device)
    _, t_seeds = derive_trial_seeds(trials, seed, offset=offset,
                                    device=device)
    fv = torch.tensor(np.asarray(freqs, np.float32), device=device)
    n = fv.shape[0]
    keys = torch.arange(n, dtype=torch.int32, device=device)
    sample = perfect.ppswor_sample(fv.expand(trials, n), k, p, t_seeds,
                                   scheme)
    tstar = transforms.transform_frequencies(keys, fv, p, t_seeds[:, None],
                                             scheme)
    return (sample, tstar.cpu().numpy(),
            sample.threshold.cpu().numpy())


# ---------------------------------------------------------------------------
# statistics over the (T,) trial axis
# ---------------------------------------------------------------------------

def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def inclusion_counts(sample_keys, n: int) -> np.ndarray:
    """(n,) per-key inclusion counts over trials (WOR: each trial counts a
    key at most once; distinctness is asserted separately)."""
    ks = to_numpy(sample_keys).reshape(-1)
    ks = ks[(ks >= 0) & (ks < n)]
    return np.bincount(ks, minlength=n)[:n].astype(np.int64)


def distinctness(sample_keys) -> np.ndarray:
    """(T,) bool: no live key appears twice within a trial's sample."""
    s = np.sort(to_numpy(sample_keys), axis=1)
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return ~dup.any(axis=1)


def live_fraction(sample_keys) -> float:
    """Mean fraction of non-padding slots across trials."""
    ks = to_numpy(sample_keys)
    return float((ks != _EMPTY).mean())


def ht_estimates(sample, p: float,
                 f: Callable[[torch.Tensor], torch.Tensor],
                 scheme: str = transforms.PPSWOR) -> np.ndarray:
    """(T,) Horvitz-Thompson estimates of sum_x f(nu_x) from a batched
    Sample (Eq. 2 per trial; padded / zero-frequency slots contribute 0).
    ``f`` is a torch callable.  As in the reference, the per-key terms and
    their sum are float32, and the sums come back as float64."""
    per = estimators.per_key_estimates(sample, p, f, scheme)
    live = (sample.keys != _EMPTY) & (torch.abs(sample.freqs) > 0)
    per = torch.where(live, per, 0.0)
    return to_numpy(torch.sum(per, dim=-1)).astype(np.float64)


def wr_moment_estimates(freqs: np.ndarray, k: int, p: float, power: float,
                        trials: int, seed: int, device=None) -> np.ndarray:
    """(T,) perfect WITH-replacement ell_p moment estimates (the paper's WR
    baseline, Sec. 7): k i.i.d. draws ~ |nu|^p, importance-weighted.

    The draws come from ``perfect.wr_sample`` under a ``torch.Generator``
    seeded with ``seed`` on ``device``; the reference draws from a JAX
    PRNG key, so the two agree in distribution only, never draw for draw."""
    device = resolve_device(device)
    w = np.abs(np.asarray(freqs, np.float64))
    probs = (w ** p) / (w ** p).sum()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fv = torch.tensor(np.asarray(freqs, np.float32), device=device)
    draws = to_numpy(perfect.wr_sample(fv.expand(trials, fv.shape[0]), k, p,
                                  gen)).astype(np.int64)
    return ((w[draws] ** power) / (k * probs[draws])).sum(axis=1)


def ks_statistic(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov statistic sup_x |F_a(x) - F_b(x)|
    (evaluated over the pooled sample points; scipy-free)."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    pooled = np.concatenate([a, b])
    fa = np.searchsorted(a, pooled, side="right") / a.size
    fb = np.searchsorted(b, pooled, side="right") / b.size
    return float(np.max(np.abs(fa - fb)))


def moment_truth(freqs: np.ndarray, power: float) -> float:
    return float((np.abs(np.asarray(freqs, np.float64)) ** power).sum())


def nrmse(estimates: np.ndarray, truth: float) -> float:
    e = np.asarray(estimates, np.float64)
    return float(np.sqrt(np.mean((e - truth) ** 2)) / abs(truth))


def sample_keys_set(sample, trial: int) -> Tuple[int, ...]:
    """Sorted live keys of one trial (debug/reporting helper)."""
    ks = to_numpy(sample.keys[trial])
    return tuple(sorted(int(x) for x in ks[ks >= 0]))
