"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

Each kernel must match its plain version here: the query bit for bit, the
scatter and the dense update within float tolerance (atomics sum in another
order), the transform within a few ulps of -log and pow.  On a CPU
tensor the kernel wrappers call these; ``chip_smoke.py`` compares the
kernels with them on the card.  They share the hashes with
``repro_torch.core.hashing``, so the kernels are drop-in replacements for
the core library's sketch ops.
"""
from __future__ import annotations

import torch

from repro_torch.core import countsketch, hashing, transforms


def stream_params(B: int, n: int, seeds, transform_seeds, lengths, device):
    """Per-stream (B,) seeds, transform seeds (uint32 in int64) and lengths
    (int64), broadcast from scalars; defaults: transform seed 0, length n."""
    seeds = hashing.as_u32(seeds, device=device).expand(B)
    if transform_seeds is None:
        transform_seeds = 0
    transform_seeds = hashing.as_u32(transform_seeds, device=device).expand(B)
    if lengths is None:
        lengths = n
    lengths = torch.as_tensor(lengths, dtype=torch.int64,
                              device=device).expand(B)
    return seeds, transform_seeds, lengths


# Each cell of a float32 scatter sums its m terms in some order; any order
# is within (m - 1) * 2**-24 * M of the exact sum, where M = sum |term|
# (Higham, "Accuracy and Stability of Numerical Algorithms", Sec. 4.2), so
# two orders differ by at most (m - 1) * eps32 * M.  The fused transform's
# -log and pow may differ between math libraries by a few ulps per term:
# TRANSFORM_ULPS * eps32 * M covers that.
EPS32 = float(torch.finfo(torch.float32).eps)
TRANSFORM_ULPS = 32


def _scatter_terms(keys, values, seeds, p, transform_seeds, lengths, scheme):
    """Per-stream seeds, the live-slot mask and the (transformed) values,
    zero in dead slots."""
    B, n = keys.shape
    seeds, tseeds, lengths = stream_params(B, n, seeds, transform_seeds,
                                           lengths, keys.device)
    pos = torch.arange(n, device=keys.device)
    valid = (pos[None, :] < lengths[:, None]) & (keys != -1)
    vals = values.to(torch.float32)
    if p is not None:
        vals = transforms.transform_values(keys, vals, p, tseeds[:, None],
                                           scheme)
    return seeds, valid, torch.where(valid, vals, 0.0)


def _scatter_rows(keys, vals, rows: int, width: int, seeds,
                  signed: bool = True) -> torch.Tensor:
    table = torch.zeros((keys.shape[0], rows, width), dtype=torch.float32,
                        device=keys.device)
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        bucket = hashing.bucket_hash(keys, salt, width)
        term = hashing.sign_hash(keys, salt) * vals if signed else vals
        table[:, r, :].scatter_add_(1, bucket, term)
    return table


def countsketch_scatter_batched_ref(keys, values, rows: int, width: int,
                                    seeds, p: float | None = None,
                                    transform_seeds=None, lengths=None,
                                    scheme: str = transforms.PPSWOR
                                    ) -> torch.Tensor:
    """Turnstile scatter of B sparse signed streams: (B, rows, width).

    Slot (b, i) counts when ``i < lengths[b]`` and ``keys[b, i] != -1``;
    duplicate keys accumulate, so an insert and its deletion cancel.  With
    ``p`` set the bottom-k transform of ``scheme`` is applied first."""
    seeds, _, vals = _scatter_terms(keys, values, seeds, p, transform_seeds,
                                    lengths, scheme)
    return _scatter_rows(keys, vals, rows, width, seeds)


def countsketch_scatter_mass_ref(keys, values, rows: int, width: int, seeds,
                                 p: float | None = None, transform_seeds=None,
                                 lengths=None,
                                 scheme: str = transforms.PPSWOR):
    """Per cell of ``countsketch_scatter_batched_ref``'s table, the number
    of terms m and their absolute mass M = sum |term|: two (B, rows, width)
    float32 tables.  Masses of several batches into one table add."""
    seeds, valid, vals = _scatter_terms(keys, values, seeds, p,
                                        transform_seeds, lengths, scheme)
    return (_scatter_rows(keys, valid.to(torch.float32), rows, width, seeds,
                          signed=False),
            _scatter_rows(keys, vals.abs(), rows, width, seeds,
                          signed=False))


def scatter_tolerance(count: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Per-cell bound on the difference between two float32 scatters of the
    same terms in different orders, with the transform from different math
    libraries: ``eps32 * (m + TRANSFORM_ULPS) * M``."""
    return EPS32 * (count + TRANSFORM_ULPS) * mass


def countsketch_scatter_ref(keys, values, rows: int, width: int, seed,
                           p: float | None = None, transform_seed=None,
                           scheme: str = transforms.PPSWOR) -> torch.Tensor:
    """Single-stream turnstile scatter: (n,) keys/values -> (rows, width)."""
    return countsketch_scatter_batched_ref(
        keys[None], values[None], rows, width, seed, p=p,
        transform_seeds=transform_seed, scheme=scheme)[0]


def _update_terms(values, seeds, p, transform_seeds, base_keys, lengths,
                  scheme):
    """Per-stream seeds, the dense keys ``base_keys[b] + i`` (uint32 wrap,
    held in int64), the live-slot mask ``i < lengths[b]`` and the
    (transformed) values, zero in dead slots.  No key is padding: a live
    key 0xFFFFFFFF is sketched."""
    B, n = values.shape
    seeds, tseeds, lengths = stream_params(B, n, seeds, transform_seeds,
                                           lengths, values.device)
    base = hashing.as_u32(0 if base_keys is None else base_keys,
                          device=values.device).expand(B)
    pos = torch.arange(n, device=values.device)
    keys = (base[:, None] + pos) & hashing.MASK32
    valid = pos[None, :] < lengths[:, None]
    vals = values.to(torch.float32)
    if p is not None:
        vals = transforms.transform_values(keys, vals, p, tseeds[:, None],
                                           scheme)
    return keys, seeds, valid, torch.where(valid, vals, 0.0)


def countsketch_update_batched_ref(values, rows: int, width: int, seeds,
                                   p: float | None = None,
                                   transform_seeds=None, base_keys=None,
                                   lengths=None,
                                   scheme: str = transforms.PPSWOR
                                   ) -> torch.Tensor:
    """CountSketch of B dense segments: (B, rows, width).

    ``values[b, i]`` is the frequency of key ``base_keys[b] + i`` (mod
    2**32) for ``i < lengths[b]``; later columns are ignored.  With ``p``
    set the bottom-k transform of ``scheme`` is applied first."""
    keys, seeds, _, vals = _update_terms(values, seeds, p, transform_seeds,
                                         base_keys, lengths, scheme)
    return _scatter_rows(keys, vals, rows, width, seeds)


def countsketch_update_mass_ref(values, rows: int, width: int, seeds,
                                p: float | None = None, transform_seeds=None,
                                base_keys=None, lengths=None,
                                scheme: str = transforms.PPSWOR):
    """Per cell of ``countsketch_update_batched_ref``'s table, the number of
    terms m and their absolute mass M = sum |term| (for
    ``scatter_tolerance``): two (B, rows, width) float32 tables."""
    keys, seeds, valid, vals = _update_terms(values, seeds, p,
                                             transform_seeds, base_keys,
                                             lengths, scheme)
    return (_scatter_rows(keys, valid.to(torch.float32), rows, width, seeds,
                          signed=False),
            _scatter_rows(keys, vals.abs(), rows, width, seeds,
                          signed=False))


def countsketch_update_ref(values, base_key, rows: int, width: int, seed,
                           p: float | None = None, transform_seed=None,
                           scheme: str = transforms.PPSWOR) -> torch.Tensor:
    """Single dense segment: (n,) values of keys ``base_key + i`` ->
    (rows, width)."""
    return countsketch_update_batched_ref(
        values[None], rows, width, seed, p=p, transform_seeds=transform_seed,
        base_keys=base_key, scheme=scheme)[0]


def ppswor_transform_ref(keys, values, p: float, seed) -> torch.Tensor:
    """v * Exp1(hash(key, seed))^(-1/p) in the values' type.  float32 as the
    fused transform; bfloat16 as the Pallas kernel: the factor is computed
    in float32 and rounded to bfloat16, and the product of the two bfloat16
    values (exact in float32) is rounded to bfloat16."""
    factor = transforms._pow32(hashing.exp1(keys, seed), -1.0 / p)
    if values.dtype == torch.float32:
        return values * factor
    if values.dtype == torch.bfloat16:
        prod = values.to(torch.float32) * factor.to(torch.bfloat16).to(
            torch.float32)
        return prod.to(torch.bfloat16)
    raise ValueError(f"ppswor_transform: values must be float32 or "
                     f"bfloat16, got {values.dtype}")


def countsketch_query_batched_ref(tables, keys, seeds) -> torch.Tensor:
    """Signed per-row reads for B streams: (B, rows, k), stream b against
    its own table and seed."""
    B, rows, width = tables.shape
    seeds = hashing.as_u32(seeds, device=tables.device).expand(B)
    out = []
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        bucket = hashing.bucket_hash(keys, salt, width)
        sign = hashing.sign_hash(keys, salt)
        out.append(torch.gather(tables[:, r, :], 1, bucket) * sign)
    return torch.stack(out, 1)


def countsketch_query_ref(table, keys, seed) -> torch.Tensor:
    """Single-stream per-row reads: (rows, k)."""
    return countsketch_query_batched_ref(table[None], keys[None], seed)[0]


def countsketch_estimate_ref(table, keys, seed) -> torch.Tensor:
    """Single-stream R.Est: (k,) median over rows (``jnp.median``
    semantics)."""
    return countsketch.median(countsketch_query_ref(table, keys, seed), 0)


def countsketch_estimate_batched_ref(tables, keys, seeds) -> torch.Tensor:
    """Batched R.Est: (B, k) median over rows (``jnp.median`` semantics)."""
    return countsketch.median(
        countsketch_query_batched_ref(tables, keys, seeds), 1)


def segment_sum_ref(values, seg) -> torch.Tensor:
    """Per-row sums of ``values`` (..., n) over the runs of equal segment
    ids ``seg`` (..., n): segment s's sum at index s, zero past the last;
    ``scatter_add_``, which on the CPU adds each run in index order."""
    return torch.zeros_like(values).scatter_add_(-1, seg, values)
