"""One-pass WORp: without-replacement ell_p sampling via an rHH sketch
(paper Sec. 5), in PyTorch.

  state   = CountSketch of transformed elements + a top-C candidate buffer
  sample  = top-k keys by estimated |nu*|, threshold = (k+1)-st estimate,
            frequencies recovered via Eq. (6).

States are NamedTuples of tensors with optional leading batch axes (the
engine's B streams); every function here works on one stream or on B.
Two-pass WORp comes with a later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import countsketch, hashing, transforms
from .perfect import Sample

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


def _dedup_topc(keys, values, priors, capacity: int):
    """Deduplicate by key (summing values; priorities of equal keys agree),
    then keep the top-``capacity`` entries by priority.  -1 keys are
    padding.  Inputs are (..., n); outputs (..., capacity)."""
    order = torch.argsort(keys, dim=-1, stable=True)
    sk = torch.gather(keys, -1, order)
    sv = torch.gather(values, -1, order)
    sp = torch.gather(priors, -1, order)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[..., 1:] = sk[..., 1:] != sk[..., :-1]
    seg = torch.cumsum(first.to(torch.int64), -1) - 1
    vsum = torch.zeros_like(sv).scatter_add_(-1, seg, sv)
    dk = torch.where(first & (sk != _EMPTY), sk, _EMPTY)
    live = dk != _EMPTY
    dv = torch.where(live, torch.gather(vsum, -1, seg), 0.0)
    dp = torch.where(live, sp, _NEG)
    top_p, top_i = top_k(dp, capacity)
    return (torch.gather(dk, -1, top_i), torch.gather(dv, -1, top_i), top_p)


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
    return _dedup_topc(all_keys, torch.zeros_like(est), est, capacity)[0]


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


def failure_test(sk: countsketch.CountSketch, sample: Sample, k: int,
                 p: float) -> torch.Tensor:
    """Appendix A 'Testing for failure': flag if the k-th estimated
    transformed frequency is not above the sketch's own error scale."""
    err = countsketch.l2_error_bound(sk, k)
    kth = torch.abs(sample.transformed).min(-1).values
    return kth < err
