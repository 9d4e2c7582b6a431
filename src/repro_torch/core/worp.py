"""WORp: without-replacement ell_p sampling via rHH sketches (paper Secs.
4-5), in PyTorch.

One-pass WORp (Sec. 5)
  state   = CountSketch of transformed elements + a top-C candidate buffer
  sample  = top-k keys by estimated |nu*|, threshold = (k+1)-st estimate,
            frequencies recovered via Eq. (6).

Two-pass WORp (Sec. 4, Algorithm 2)
  pass I  = CountSketch R of transformed elements
  pass II = top-C buffer T keyed by FROZEN priorities |R.Est|, accumulating
            exact frequencies (Lemma 4.2: priorities never change during
            pass II, so a key in the final buffer was kept from its first
            pass-II appearance and its count is exact).
  sample  = top-k stored keys by exact |nu*| = |nu_x| / r_x^{1/p}.

States are NamedTuples of tensors with optional leading batch axes (the
engine's B streams); every function here works on one stream or on B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import countsketch, hashing, transforms
from .device import resolve_device
from .perfect import Sample
from ..trace import span

_EMPTY = -1
_NEG = float("-inf")


def check_merge_seeds(fn: str, **seed_pairs) -> None:
    """Raise if any named (a, b) seed pair disagrees: merging states whose
    transform (or sketch hash) seeds differ yields garbage."""
    for name, (sa, sb) in seed_pairs.items():
        if hashing.seeds_concretely_differ(sa, sb):
            raise ValueError(
                f"{fn}: cannot merge states with different {name} "
                f"({sa!r} vs {sb!r}) -- shards must be built from identical "
                f"seeds or the merged sample is garbage (the paper's "
                f"composability requires the shared-hash agreement of "
                f"Sec. 2.2)")


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: descending, ties and -inf
    padding broken by the lowest index (a stable descending sort; plain
    ``torch.topk`` orders ties differently)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def segment_sum(values: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Sums of ``values`` (..., n) over runs of equal, nondecreasing segment
    ids ``seg`` (..., n): segment s's sum at index s of the last axis, zero
    past the last segment.

    ``scatter_add_`` by default: in index order on the CPU, in an order
    that varies from run to run on the card (atomics).  Under
    ``torch.use_deterministic_algorithms(True)`` the sorted segment-sum
    kernel (``kernels.ops.segment_sum``), which adds each run in index
    order on the card: the same bits every run, and the CPU's.  PyTorch's
    own deterministic ``scatter_add_`` costs more than the flush it sits
    in (PERF.md)."""
    if torch.are_deterministic_algorithms_enabled():
        from repro_torch.kernels import ops

        return ops.segment_sum(values, seg)
    return torch.zeros_like(values).scatter_add_(-1, seg, values)


def _key_sort(keys, *carried):
    """``keys`` (..., n) sorted along the last axis, equal keys in their
    order of arrival (a stable sort), and each of ``carried`` gathered
    into that order."""
    with span("dedup.sort"):
        sk, order = torch.sort(keys, dim=-1, stable=True)
        return (sk,) + tuple(torch.gather(c, -1, order) for c in carried)


def _run_starts(sk):
    """True at the first slot of each run of equal sorted keys."""
    first = torch.ones_like(sk, dtype=torch.bool)
    first[..., 1:] = sk[..., 1:] != sk[..., :-1]
    return first


def _top_c(dk, sp, capacity: int, *carried):
    """The top-``capacity`` run heads ``dk`` (-1 elsewhere) by priority
    ``sp``: (keys, each of ``carried``, priorities), (..., capacity).
    Ties break by position, that is by ascending key; NaN ranks first."""
    with span("dedup.topc"):
        dp = torch.where(dk != _EMPTY, sp, _NEG)
        top_p, top_i = top_k(dp, capacity)
        return (torch.gather(dk, -1, top_i),
                *(torch.gather(c, -1, top_i) for c in carried), top_p)


def _dedup_keys_topc(keys, priors, capacity: int):
    """``_dedup_topc`` with no values: the kept keys and their priorities
    alone, with no sum built (the candidate refresh keeps keys only)."""
    sk, sp = _key_sort(keys, priors)
    with span("dedup.segsum"):
        # a padding run's head is -1 itself: where(first, sk, -1) masks it
        dk = torch.where(_run_starts(sk), sk, _EMPTY)
    del sk  # not held through the top-C sort
    return _top_c(dk, sp, capacity)


def _dedup_topc(keys, values, priors, capacity: int):
    """Deduplicate by key (summing values; priorities of equal keys agree),
    then keep the top-``capacity`` entries by priority.  -1 keys are
    padding.  Inputs are (..., n); outputs (..., capacity)."""
    sk, sv, sp = _key_sort(keys, values, priors)
    with span("dedup.segsum"):
        first = _run_starts(sk)
        seg = torch.cumsum(first.to(torch.int64), -1) - 1
        vsum = segment_sum(sv, seg)
        dk = torch.where(first, sk, _EMPTY)
        dv = torch.where(dk != _EMPTY, torch.gather(vsum, -1, seg), 0.0)
    return _top_c(dk, sp, capacity, dv)


class OnePassState(NamedTuple):
    sketch: countsketch.CountSketch
    cand_keys: torch.Tensor       # (..., C) int32 candidate keys (-1 = empty)
    seed_transform: torch.Tensor  # (...) int64 uint32 seeds of r_x


def onepass_init(rows: int, width: int, candidates: int, seed_sketch,
                 seed_transform, device=None) -> OnePassState:
    """Empty state; the batch shape is the shape of the seeds.  It lives
    where ``countsketch.init`` puts the sketch: on ``device``, else on a
    tensor ``seed_sketch``'s device, else on the card."""
    sk = countsketch.init(rows, width, seed_sketch, device=device)
    return OnePassState(
        sketch=sk,
        cand_keys=torch.full(sk.seed.shape + (candidates,), _EMPTY,
                             dtype=torch.int32, device=sk.seed.device),
        seed_transform=hashing.as_u32(seed_transform, device=sk.seed.device))


def refresh_candidates(sk: countsketch.CountSketch, cand_keys, keys,
                       capacity: int | None = None) -> torch.Tensor:
    """THE candidate-buffer policy: top-``capacity`` of (old candidates U
    new keys) by current |R.Est|, -1 keys masked out."""
    all_keys = torch.cat([cand_keys, keys.to(cand_keys.dtype)], -1)
    est = torch.abs(countsketch.estimate(sk, all_keys))
    return _refresh_from_estimates(all_keys, est, capacity
                                   or cand_keys.shape[-1])


def _refresh_from_estimates(all_keys, est_abs, capacity: int):
    est = torch.where(all_keys == _EMPTY, _NEG, est_abs)
    return _dedup_keys_topc(all_keys, est, capacity)[0]


def onepass_update(st: OnePassState, keys, values, p: float,
                   scheme: str = transforms.PPSWOR) -> OnePassState:
    """Process an element batch: transform (Eq. 5), sketch, refresh
    candidates."""
    keys = keys.to(torch.int32)
    tvals = transforms.transform_values(
        keys, values.to(torch.float32), p, st.seed_transform[..., None],
        scheme)
    sk = countsketch.update(st.sketch, keys, tvals)
    ck = refresh_candidates(sk, st.cand_keys, keys)
    return OnePassState(sketch=sk, cand_keys=ck,
                        seed_transform=st.seed_transform)


def onepass_merge(a: OnePassState, b: OnePassState) -> OnePassState:
    check_merge_seeds("onepass_merge",
                      seed_transform=(a.seed_transform, b.seed_transform))
    sk = countsketch.merge(a.sketch, b.sketch)
    ck = refresh_candidates(sk, a.cand_keys, b.cand_keys)
    return OnePassState(sketch=sk, cand_keys=ck,
                        seed_transform=a.seed_transform)


def _check_sample_k(k: int, slots: int, fn: str, knob: str) -> None:
    """The (k+1)-st entry is the threshold, so k < slots."""
    if k + 1 > slots:
        raise ValueError(
            f"{fn}: k={k} needs k < {knob}={slots} (the (k+1)-st stored "
            f"estimate is the sample threshold); raise {knob} or lower k")


def onepass_sample_from_estimates(st: OnePassState, est: torch.Tensor,
                                  k: int, p: float,
                                  scheme: str = transforms.PPSWOR) -> Sample:
    """``onepass_sample`` with the candidate estimates precomputed -- the
    seam that lets the engine obtain ``est`` for all B streams from one
    query-kernel launch."""
    _check_sample_k(k, st.cand_keys.shape[-1], "onepass_sample", "candidates")
    mag = torch.where(st.cand_keys == _EMPTY, _NEG, torch.abs(est))
    top_mag, top_i = top_k(mag, k + 1)
    sel = torch.gather(st.cand_keys, -1, top_i[..., :k])
    est_sel = torch.gather(est, -1, top_i[..., :k])
    freqs = transforms.invert_frequency(sel, est_sel, p,
                                        st.seed_transform[..., None], scheme)
    # padded slots (underfull buffers) report zero frequency and estimate
    pad = sel == _EMPTY
    return Sample(keys=sel,
                  freqs=torch.where(pad, 0.0, freqs),
                  threshold=top_mag[..., k],
                  transformed=torch.where(pad, 0.0, est_sel))


def onepass_sample(st: OnePassState, k: int, p: float,
                   scheme: str = transforms.PPSWOR) -> Sample:
    """Top-k candidates by estimated |nu*|; threshold = (k+1)-st estimate;
    approximate frequencies nu' via Eq. (6)."""
    est = countsketch.estimate(st.sketch, st.cand_keys)
    return onepass_sample_from_estimates(st, est, k, p, scheme)


# ---------------------------------------------------------------------------
# Two-pass WORp (Algorithm 2)
# ---------------------------------------------------------------------------

class TwoPassState(NamedTuple):
    """Pass-II structure T: exact frequencies keyed by frozen priorities."""
    keys: torch.Tensor            # (..., capacity) int32 (-1 = empty)
    freqs: torch.Tensor           # (..., capacity) float32 exact nu_x
    priority: torch.Tensor        # (..., capacity) float32 frozen |R.Est|
    seed_transform: torch.Tensor  # (...) int64 uint32 seeds of r_x


def twopass_init(capacity: int, seed_transform, device=None) -> TwoPassState:
    """Empty buffer; the batch shape is the shape of ``seed_transform``.  It
    lives on ``device``, else on a tensor seed's device, else on the
    card."""
    if device is not None or not isinstance(seed_transform, torch.Tensor):
        device = resolve_device(device)
    seed = hashing.as_u32(seed_transform, device=device)
    shape = seed.shape + (capacity,)
    return TwoPassState(
        keys=torch.full(shape, _EMPTY, dtype=torch.int32, device=seed.device),
        freqs=torch.zeros(shape, dtype=torch.float32, device=seed.device),
        priority=torch.full(shape, _NEG, dtype=torch.float32,
                            device=seed.device),
        seed_transform=seed)


def _twopass_combine(st: TwoPassState, keys, values, prio) -> TwoPassState:
    nk, nv, np_ = _dedup_topc(torch.cat([st.keys, keys], -1),
                              torch.cat([st.freqs, values], -1),
                              torch.cat([st.priority, prio], -1),
                              st.keys.shape[-1])
    return TwoPassState(keys=nk, freqs=nv, priority=np_,
                        seed_transform=st.seed_transform)


def twopass_update_from_priorities(st: TwoPassState, keys, values,
                                   prio) -> TwoPassState:
    """``twopass_update`` with the |R.Est| priorities precomputed -- the
    seam that lets the engine obtain the priorities of all B streams from
    one estimate-kernel launch."""
    keys = keys.to(torch.int32)
    prio = torch.where(keys == _EMPTY, _NEG, torch.abs(prio))
    return _twopass_combine(st, keys, values.to(torch.float32), prio)


def twopass_update(st: TwoPassState, frozen: countsketch.CountSketch, keys,
                   values) -> TwoPassState:
    """Pass-II step: accumulate exact frequencies of top-priority keys.
    ``frozen`` is the (merged, global) pass-I sketch: its priorities do not
    change during pass II."""
    keys = keys.to(torch.int32)
    prio = countsketch.estimate(frozen, keys)
    return twopass_update_from_priorities(st, keys, values, prio)


def twopass_merge(a: TwoPassState, b: TwoPassState) -> TwoPassState:
    check_merge_seeds("twopass_merge",
                      seed_transform=(a.seed_transform, b.seed_transform))
    return _twopass_combine(a, b.keys, b.freqs, b.priority)


def _exact_magnitudes(st: TwoPassState, p: float, scheme: str):
    """nu* of the stored keys and |nu*| with empty slots at -inf."""
    safe_keys = torch.where(st.keys == _EMPTY, 0, st.keys)
    tstar = transforms.transform_frequencies(
        safe_keys, st.freqs, p, st.seed_transform[..., None], scheme)
    return tstar, torch.where(st.keys == _EMPTY, _NEG, torch.abs(tstar))


def twopass_sample(st: TwoPassState, k: int, p: float,
                   scheme: str = transforms.PPSWOR) -> Sample:
    """Final sample: top-k stored keys by EXACT |nu*|, exact frequencies."""
    _check_sample_k(k, st.keys.shape[-1], "twopass_sample", "capacity")
    tstar, mag = _exact_magnitudes(st, p, scheme)
    top_mag, top_i = top_k(mag, k + 1)
    sel = top_i[..., :k]
    return Sample(keys=torch.gather(st.keys, -1, sel),
                  freqs=torch.gather(st.freqs, -1, sel),
                  threshold=top_mag[..., k],
                  transformed=torch.gather(tstar, -1, sel))


def twopass_extended_sample(st: TwoPassState, k: int, p: float,
                            scheme: str = transforms.PPSWOR):
    """Sec. 4.1's second practical optimization: certify a larger effective
    sample.  Any key with nu* >= L + nu*_(k+1) / 3 (L the least retained
    priority) must be stored; returns a boolean mask over the stored slots
    and the threshold (the least certified nu*)."""
    _check_sample_k(k, st.keys.shape[-1], "twopass_extended_sample",
                    "capacity")
    _, mag = _exact_magnitudes(st, p, scheme)
    err = top_k(mag, k + 1)[0][..., k] / 3.0
    live_prio = torch.where(st.keys == _EMPTY, float("inf"), st.priority)
    # under k + 1 stored keys err = -inf (and an empty buffer has L = inf):
    # a non-finite bar certifies nothing
    bar = live_prio.min(-1).values + err
    bar = torch.where(torch.isfinite(bar), bar, float("inf"))
    certified = (st.keys != _EMPTY) & (mag >= bar[..., None])
    tau = torch.where(certified, mag, float("inf")).min(-1).values
    return certified, tau


def failure_test(sk: countsketch.CountSketch, sample: Sample, k: int,
                 p: float) -> torch.Tensor:
    """Appendix A 'Testing for failure': flag if the k-th estimated
    transformed frequency is not above the sketch's own error scale."""
    err = countsketch.l2_error_bound(sk, k)
    kth = torch.abs(sample.transformed).min(-1).values
    return kth < err
