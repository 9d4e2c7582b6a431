"""Counter-based ell_1 rHH sketch (Misra-Gries / SpaceSaving family).

Positive-value elements only (paper Table 1, 'Counters (ell_1, +)').  A
sketch with m counters gives frequency estimates with additive error at
most ||tail_k(nu)||_1 / (m - k) [Berinde et al., rHH adaptation].

Fixed capacity: the state is (keys, counts) tensors of shape (m,); empty
slots hold key -1.  Merge follows the mergeable-summaries construction
[Agarwal et al.]: sum the counts of common keys, keep the top m by count,
and subtract the (m+1)-st count from every survivor (the Misra-Gries
offset), which keeps the underestimate and its error bound.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .worp import segment_sum, top_k

_EMPTY = -1


class Counters(NamedTuple):
    keys: torch.Tensor    # (m,) int32, -1 = empty
    counts: torch.Tensor  # (m,) float32 (Misra-Gries lower-bound counts)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def init(capacity: int, device=None) -> Counters:
    """Empty counters on ``device`` (the card unless the caller asks
    otherwise)."""
    device = resolve_device(device)
    return Counters(
        keys=torch.full((capacity,), _EMPTY, dtype=torch.int32,
                        device=device),
        counts=torch.zeros((capacity,), dtype=torch.float32, device=device))


def _dedup(keys: torch.Tensor, values: torch.Tensor):
    """Keys sorted (stable), a flag on the first of each run of equal keys,
    the run's index of every entry, and the runs' sums (at the run index,
    summed in sorted order by ``worp.segment_sum``)."""
    order = torch.argsort(keys, stable=True)
    sk, sv = keys[order], values[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    return sk, first, seg, segment_sum(sv, seg)


def _aggregate_batch(keys: torch.Tensor, values: torch.Tensor):
    """Combine duplicate keys within a batch (sum their values).  Returns
    (unique_keys, sums) of the same length with -1 padding."""
    sk, first, seg, sums = _dedup(keys, values)
    uk = torch.where(first, sk, _EMPTY)
    us = torch.where(first, sums[seg], 0.0)
    return uk, us.to(torch.float32)


def _combine(keys_a, counts_a, keys_b, counts_b,
             capacity: int) -> Counters:
    """Combine two (key, count) multisets; keep the top ``capacity`` with
    the Misra-Gries offset."""
    sk, first, seg, sums = _dedup(torch.cat([keys_a, keys_b]),
                                  torch.cat([counts_a, counts_b]))
    dk = torch.where(first, sk, _EMPTY)
    dc = torch.where(first & (dk != _EMPTY), sums[seg], float("-inf"))
    # the top capacity by count; the (capacity+1)-st is the offset
    top_c, top_i = top_k(dc, capacity + 1)
    offset = torch.clamp(top_c[capacity], min=0.0)
    offset = torch.where(torch.isfinite(offset), offset, 0.0)
    keep_c = top_c[:capacity]
    keep_k = dk[top_i[:capacity]]
    alive = torch.isfinite(keep_c) & (keep_k != _EMPTY)
    new_counts = torch.where(alive, torch.clamp(keep_c - offset, min=0.0),
                             0.0)
    new_keys = torch.where(alive & (new_counts > 0), keep_k, _EMPTY)
    return Counters(keys=new_keys, counts=new_counts)


def update(cs: Counters, keys, values) -> Counters:
    """Process a batch of positive-valued elements."""
    keys = torch.as_tensor(keys, dtype=torch.int32, device=cs.keys.device)
    values = torch.as_tensor(values, dtype=torch.float32,
                             device=cs.keys.device)
    uk, us = _aggregate_batch(keys, values)
    us = torch.where(uk == _EMPTY, float("-inf"), us)
    us = torch.where(torch.isfinite(us), us, 0.0) \
        * torch.where(uk == _EMPTY, 0.0, 1.0)
    return _combine(cs.keys, cs.counts, uk, us, cs.capacity)


def merge(a: Counters, b: Counters) -> Counters:
    return _combine(a.keys, a.counts, b.keys, b.counts, a.capacity)


def estimate(cs: Counters, keys) -> torch.Tensor:
    """Lower-bound estimates: the stored count where present, else 0."""
    keys = torch.as_tensor(keys, dtype=torch.int32, device=cs.keys.device)
    eq = cs.keys[None, :] == keys[:, None]  # (n, m)
    return torch.where(eq, cs.counts[None, :], 0.0).sum(1)


def stored(cs: Counters):
    """(keys, counts) of the live slots (padded with -1 / 0)."""
    alive = cs.keys != _EMPTY
    return (torch.where(alive, cs.keys, _EMPTY),
            torch.where(alive, cs.counts, 0.0))
