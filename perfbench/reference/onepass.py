"""The reference's side of a one-pass WORp engine's checks: tables worked
out from the inputs alone (the sketch is linear, so the table after any
replay is the sum of each distinct batch's sketch times its count), the
candidate rule applied to the program's previous candidates, and the
sample rule applied to the program's candidates."""
from __future__ import annotations

from collections import Counter

import torch

from . import compare, hashing, sketch

NEG = -torch.inf


def tables(log: list, targets: dict, delta_of, absolute_target=None):
    """float64 tables after the updates ``log[:u + 1]`` for each
    ``targets[name] = u``, from ``delta_of(batch, absolute) -> (B, rows,
    width)`` computed once a distinct batch; with ``absolute_target`` also
    the sum of |terms| of that target's tables."""
    counts = {name: Counter(log[:u + 1]) for name, u in targets.items()}
    out, absum = {}, None
    for batch in dict.fromkeys(log):
        delta = delta_of(batch, False)
        for name, c in counts.items():
            if c[batch]:
                out[name] = out[name] + c[batch] * delta \
                    if name in out else c[batch] * delta
        del delta
        if absolute_target is not None and counts[absolute_target][batch]:
            a = counts[absolute_target][batch] * delta_of(batch, True)
            absum = a if absum is None else absum + a
    return out, absum


def refresh_gap(table, seeds, cand_before, keys, cand_after) -> float:
    """The program's candidates after one update against the candidate
    rule over (its candidates before U the update's keys), both ranked by
    the reference's estimates from ``table``."""
    capacity = cand_after.shape[1]
    pool = sketch.unique_pool(torch.cat([cand_before.to(torch.int64),
                                         keys.to(torch.int64)], 1))
    prio = torch.where(pool == -1, NEG,
                       sketch.priority(sketch.estimate(table, pool, seeds)))
    ref_top = sketch.top_priorities(prio, capacity)
    got = compare.lookup(cand_after, pool, prio)
    return compare.rank_gap(ref_top, got, compare.finite_scale(ref_top))


def dense_top(table, seeds, lengths, n: int, c: int):
    """The c keys of [0, length) with the largest |R.Est| of each dense
    stream (ties, NaN first, to the lower key): (priorities, keys), each
    (B, c), in column blocks."""
    B = table.shape[0]
    dev = table.device
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    best_p = torch.full((B, 0), NEG, dtype=torch.float64, device=dev)
    best_k = torch.full((B, 0), -1, dtype=torch.int64, device=dev)
    step = max(c, sketch.BLOCK_PAIRS // (B * table.shape[1]))
    for lo in range(0, n, step):
        cols = torch.arange(lo, min(n, lo + step), dtype=torch.int64,
                            device=dev).expand(B, -1)
        ok = cols < lengths[:, None]
        keys = torch.where(ok, cols, -1)
        p = torch.where(ok, sketch.priority(
            sketch.estimate(table, keys, seeds)), NEG)
        allp = torch.cat([best_p, p], 1)
        allk = torch.cat([best_k, keys], 1)
        order = torch.sort(allp, dim=1, descending=True, stable=True).indices
        best_p = torch.gather(allp, 1, order[:, :c])
        best_k = torch.gather(allk, 1, order[:, :c])
    return best_p, best_k


def dense_refresh_gap(table, seeds, lengths, n: int, cand_after) -> float:
    """The program's candidates after a dense update of every key of each
    segment: the candidate rule then ranks all of them, so the reference's
    best are the top of all keys."""
    ref_top, _ = dense_top(table, seeds, lengths, n, cand_after.shape[1])
    lengths = torch.as_tensor(lengths, dtype=torch.int64,
                              device=table.device)
    k = cand_after.to(torch.int64)
    inside = (k >= 0) & (k < lengths[:, None])
    got = torch.where(inside, sketch.priority(sketch.estimate(
        table, torch.where(inside, k, -1), seeds)), NEG)
    got = torch.where(compare.repeats(k), NEG, got)
    return compare.rank_gap(ref_top, got, compare.finite_scale(ref_top))


def sample_errs(table, seeds, tseeds, cand, keys, freqs, threshold, k: int,
                p: float, scheme: str) -> tuple[float, float]:
    """(rank gap of the sampled keys, widest error of their frequencies and
    of the threshold) of a program's sample drawn from its candidates
    ``cand``: the top k of the candidates by the reference's |R.Est|,
    frequencies by Eq. 6, the threshold the (k+1)-st |R.Est|."""
    pool = sketch.unique_pool(cand)
    prio = torch.where(pool == -1, NEG,
                       sketch.priority(sketch.estimate(table, pool, seeds)))
    ref_sorted = sketch.top_priorities(prio, k + 1)
    ref_top, ref_thr = ref_sorted[:, :k], ref_sorted[:, k:k + 1]
    scale_e = compare.finite_scale(ref_top)
    got = compare.lookup(keys, pool, prio)
    gap = compare.rank_gap(ref_top, got, scale_e)
    k64 = keys.to(torch.int64)
    est = sketch.estimate(table, k64, seeds)
    want = est * hashing.inverse_factor(hashing.u32(k64), tseeds[:, None],
                                        p, scheme)
    want = torch.where(k64 == -1, 0.0, want)
    f_err = compare.value_err(freqs, want, compare.finite_scale(want))
    thr = threshold.to(torch.float64).reshape(-1, 1).abs()
    thr = torch.where(torch.isnan(thr), torch.inf, thr)
    t_err = compare.value_err(thr, ref_thr, scale_e)
    return gap, max(f_err, t_err)
