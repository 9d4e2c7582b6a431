"""Plain PyTorch CountSketch of ppswor-transformed values, its estimates,
and the one-pass candidate and sample rules, for B streams at once.

Everything here is written from the paper's definitions (Cohen, Pagh and
Woodruff, "WOR and p's", Secs. 2 and 5) and the frozen hash, in a dtype of
the caller's choice: float64 for the reference, bfloat16 for the control
that stands in the program's place.  Large batches go through in column
blocks, so the card holds only a block's temporaries at a time.
"""
from __future__ import annotations

import torch

from . import hashing

# columns of a (B, n) batch hashed at once: about this many (stream, column)
# pairs a block
BLOCK_PAIRS = 1 << 24


def _blocks(batch: int, n: int):
    step = max(1, BLOCK_PAIRS // max(batch, 1))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def scatter(keys: torch.Tensor, values: torch.Tensor, seeds: torch.Tensor,
            tseeds: torch.Tensor, rows: int, width: int, p: float,
            scheme: str, dtype=torch.float64, absolute: bool = False,
            valid: torch.Tensor | None = None) -> torch.Tensor:
    """(B, rows, width) sketch of B streams' signed (key, value) updates,
    each value transformed by its key's r ** (-1/p) first.

    ``keys`` (B, n) hold integers (int32 -1 is padding unless ``valid``
    says otherwise); ``absolute`` sums |transformed value| instead, the
    scale a cell's rounding error is measured against."""
    B, n = keys.shape
    dev = keys.device
    table = torch.zeros(B * rows * width, dtype=dtype, device=dev)
    base = torch.arange(B, device=dev)[:, None] * rows
    seeds, tseeds = seeds[:, None], tseeds[:, None]
    for lo, hi in _blocks(B, n):
        k = keys[:, lo:hi]
        ok = (k != -1) if valid is None else valid[:, lo:hi]
        k = hashing.u32(k)
        factor = hashing.transform_factor(k, tseeds, p, scheme).to(dtype)
        tv = torch.where(ok, values[:, lo:hi].to(dtype) * factor,
                         torch.zeros((), dtype=dtype, device=dev))
        if absolute:
            tv = tv.abs()
        for r in range(rows):
            bucket, sign = hashing.bucket_sign(
                k, hashing.row_salt(seeds, r), width)
            idx = ((base + r) * width + bucket).reshape(-1)
            contrib = tv if absolute else tv * sign.to(dtype)
            table.index_add_(0, idx, contrib.reshape(-1))
    return table.reshape(B, rows, width)


def dense_keys(lengths, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys 0..n-1 of B dense segments and the mask of slots inside each
    segment's length."""
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=device)
    cols = torch.arange(n, dtype=torch.int64, device=device)
    keys = cols.expand(lengths.shape[0], n)
    return keys, cols[None, :] < lengths[:, None]


def median_rows(vals: torch.Tensor) -> torch.Tensor:
    """Median over dim -2 (the rows): the middle value, or the mean of the
    two middle ones for an even count; NaN where a row reads NaN."""
    rows = vals.shape[-2]
    s = torch.sort(vals, dim=-2).values
    mid = (s.narrow(-2, (rows - 1) // 2, 1) + s.narrow(-2, rows // 2, 1)) / 2
    return torch.where(torch.isnan(vals).any(-2), torch.nan, mid.squeeze(-2))


def estimate(table: torch.Tensor, keys: torch.Tensor,
             seeds: torch.Tensor) -> torch.Tensor:
    """R.Est of (B, m) keys: the median over rows of sign * bucket, in the
    table's dtype; -1 keys read NaN."""
    B, rows, width = table.shape
    out = torch.empty(keys.shape, dtype=table.dtype, device=table.device)
    seeds = seeds[:, None]
    for lo, hi in _blocks(B * rows, keys.shape[1]):
        k = hashing.u32(keys[:, lo:hi])
        vals = []
        for r in range(rows):
            bucket, sign = hashing.bucket_sign(
                k, hashing.row_salt(seeds, r), width)
            vals.append(torch.gather(table[:, r, :], 1, bucket)
                        * sign.to(table.dtype))
        est = median_rows(torch.stack(vals, 1))
        out[:, lo:hi] = torch.where(keys[:, lo:hi] == -1, torch.nan, est)
    return out


def priority(est: torch.Tensor) -> torch.Tensor:
    """The rank a key takes by |estimate|, as float64: a NaN estimate ranks
    above every number (a descending sort puts it first)."""
    mag = est.abs().to(torch.float64)
    return torch.where(torch.isnan(mag), torch.inf, mag)


def unique_pool(keys: torch.Tensor) -> torch.Tensor:
    """Each stream's distinct keys, sorted, -1 (and repeats) pushed to the
    end as -1: (B, m)."""
    s = torch.sort(keys.to(torch.int64), dim=1).values
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.where(rep | (s == -1), torch.iinfo(torch.int64).max, s)
    s = torch.sort(s, dim=1).values
    return torch.where(s == torch.iinfo(torch.int64).max, -1, s)


def top_priorities(prio: torch.Tensor, c: int) -> torch.Tensor:
    """The c largest priorities of each row, descending (-inf past the
    row's keys)."""
    c = min(c, prio.shape[1])
    return torch.topk(prio, c, dim=1).values


def refresh_keys(table, seeds, cand: torch.Tensor, keys: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """The one-pass candidate rule (Sec. 5): the ``capacity`` keys of
    (candidates U new keys) with the largest |R.Est|, -1 for empty slots;
    ties (NaN first) to the lower key."""
    pool = unique_pool(torch.cat([cand.to(torch.int64),
                                  keys.to(torch.int64)], 1))
    prio = torch.where(pool == -1, -torch.inf,
                       priority(estimate(table, pool, seeds)))
    order = torch.sort(prio, dim=1, descending=True, stable=True).indices
    top = torch.gather(pool, 1, order[:, :capacity])
    if top.shape[1] < capacity:
        top = torch.cat([top, torch.full(
            (top.shape[0], capacity - top.shape[1]), -1, dtype=top.dtype,
            device=top.device)], 1)
    return top
