"""Composable CountSketch (ell_2 rHH sketch; Charikar-Chen-Farach-Colton).

The sketch is LINEAR in the input frequency vector: process/merge are sums,
which is what gives WORp its signed-update (turnstile) support.

Every function takes optional leading batch axes: ``table`` is
``(..., rows, width)``, ``seed`` is ``(...)`` and keys are ``(..., n)``, so
one call serves a single sketch or the engine's B streams.  This plain
PyTorch code is the reference the CUDA kernels are held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hashing
from .device import resolve_device


class CountSketch(NamedTuple):
    table: torch.Tensor  # (..., rows, width) float32
    seed: torch.Tensor   # (...) int64 holding uint32 hash-family seeds

    @property
    def rows(self) -> int:
        return self.table.shape[-2]

    @property
    def width(self) -> int:
        return self.table.shape[-1]


def init(rows: int, width: int, seed, device=None,
         dtype=torch.float32) -> CountSketch:
    """Zero sketch; the batch shape is the shape of ``seed``.

    It lives on ``device``: by default a tensor seed's own device, and the
    card for any other seed (raising without one; pass ``device="cpu"``
    for the plain path)."""
    if device is not None or not isinstance(seed, torch.Tensor):
        device = resolve_device(device)
    seed = hashing.as_u32(seed, device=device)
    return CountSketch(
        table=torch.zeros(seed.shape + (rows, width), dtype=dtype,
                          device=seed.device),
        seed=seed)


def _row_buckets_signs(sk: CountSketch, keys: torch.Tensor):
    """(..., rows, n) bucket ids (int64) and signs (float32) for keys
    (..., n)."""
    seed = sk.seed[..., None]
    buckets, signs = [], []
    for r in range(sk.rows):
        salt = hashing.row_salt(seed, r)
        buckets.append(hashing.bucket_hash(keys, salt, sk.width))
        signs.append(hashing.sign_hash(keys, salt))
    return torch.stack(buckets, -2), torch.stack(signs, -2)


def update(sk: CountSketch, keys: torch.Tensor,
           values: torch.Tensor) -> CountSketch:
    """Process a batch of elements (key, value).  Linear: values may be
    signed, and updating with ``-values`` cancels a prior update."""
    buckets, signs = _row_buckets_signs(sk, keys)
    sv = signs * values.to(sk.table.dtype)[..., None, :]   # (..., rows, n)
    width = sk.width
    n = buckets.shape[-1]
    flat_rows = sk.table.numel() // width
    offs = (torch.arange(flat_rows, device=buckets.device) * width)[:, None]
    index = (offs + buckets.reshape(flat_rows, n)).reshape(-1)
    table = sk.table.clone()
    table.view(-1).index_add_(0, index, sv.reshape(-1))
    return CountSketch(table=table, seed=sk.seed)


def merge(a: CountSketch, b: CountSketch) -> CountSketch:
    """Merge sketches of two datasets (same params and seed): table sum."""
    if hashing.seeds_concretely_differ(a.seed, b.seed):
        raise ValueError(
            f"countsketch.merge: cannot merge sketches with different hash "
            f"seeds ({a.seed!r} vs {b.seed!r}) -- bucket/sign hashes "
            f"disagree, so the summed table is garbage")
    return CountSketch(table=a.table + b.table, seed=a.seed)


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median with ``jnp.median`` semantics: the mean of the two middle
    values for an even count (``torch.median`` returns the lower one), and
    NaN wherever the reduced slice holds a NaN."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    out = ((lo + hi) * 0.5).squeeze(dim)
    return torch.where(torch.isnan(x).any(dim), float("nan"), out)


def estimate(sk: CountSketch, keys: torch.Tensor) -> torch.Tensor:
    """R.Est(x): median over rows of sign * bucket; (..., n)."""
    buckets, signs = _row_buckets_signs(sk, keys)
    vals = torch.gather(sk.table, -1, buckets) * signs   # (..., rows, n)
    return median(vals, -2)


def l2_error_bound(sk: CountSketch, k: int) -> torch.Tensor:
    """Data-driven proxy of the (k, psi)-rHH error scale, ||tail_k||_2 /
    sqrt(width): each row drops its k_eff largest squared buckets (the heavy
    hitters) before summing; k_eff is clamped to width/2."""
    sq = sk.table.to(torch.float32) ** 2
    k_eff = max(1, min(k, sk.width // 2))
    row_l2 = sq.sum(-1) - torch.topk(sq, k_eff, dim=-1).values.sum(-1)
    # fp32 cancellation can leave the difference slightly negative
    row_l2 = torch.clamp(row_l2, min=0.0)
    return torch.sqrt(median(row_l2, -1) / sk.width)


def estimate_single_row(sk: CountSketch, keys: torch.Tensor,
                        row: int) -> torch.Tensor:
    """One row's signed read of ``keys`` (..., n): sign * bucket of row
    ``row``, the unbiased per-row estimate."""
    salt = hashing.row_salt(sk.seed[..., None], row)
    bucket = hashing.bucket_hash(keys, salt, sk.width)
    return (torch.gather(sk.table[..., row, :], -1, bucket)
            * hashing.sign_hash(keys, salt))


def sketch_vector(vec: torch.Tensor, rows: int, width: int,
                  seed) -> CountSketch:
    """Sketch a dense frequency vector ``vec`` (..., n): keys ``[0, n)``,
    through the plain ``update`` (no kernel), on ``vec``'s device."""
    sk = init(rows, width, seed, device=vec.device, dtype=vec.dtype)
    keys = torch.arange(vec.shape[-1], device=vec.device)
    return update(sk, keys.expand(vec.shape), vec)
