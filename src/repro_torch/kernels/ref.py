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


def _lead_sums(tags, terms, live):
    """Per 32-slot group (B, m): the live slots of one tag sum their terms
    in slot order to the lowest of them, their lead, ``((t1 + t2) + t3) +
    ...`` in float32.  Returns the leads' mask and their sums (zero
    elsewhere)."""
    B, m = tags.shape
    lane = torch.arange(m, device=tags.device)
    same = (tags[:, :, None] == tags[:, None, :]) & live[:, :, None] \
        & live[:, None, :]
    # the lowest live slot with this slot's tag (its own index if none)
    lead = torch.where(same.any(1), same.to(torch.int8).argmax(1), lane)
    is_lead = live & (lead == lane)
    sums = torch.where(is_lead, terms, 0.0)
    for j in range(m):  # slot order
        add = live[:, j] & ~is_lead[:, j]
        at = lead[:, j:j + 1]
        acc = sums.gather(1, at)[:, 0]
        sums.scatter_(1, at, torch.where(add, acc + terms[:, j], acc)[:, None])
    return is_lead, sums


def countsketch_scatter_det_ref(keys, values, rows: int, width: int, seeds,
                                p: float | None = None, transform_seeds=None,
                                lengths=None,
                                scheme: str = transforms.PPSWOR
                                ) -> torch.Tensor:
    """The deterministic scatter's summation order (csrc/smem_table.cuh
    det_table_block), in float32, slot by slot: (B, rows, width).

    In each group of 32 slots (from slot 0) the live slots of one key sum
    their transformed values in slot order to the lowest of them; in each
    row the leads whose keys share a bucket sum their signed sums in slot
    order, and the cell adds that; groups add in slot order, each cell from
    0.0.  With ``p`` set the transform is the plain version's, so only with
    ``p=None`` (or values transformed by the card) does the kernel give
    these bits."""
    seeds, valid, vals = _scatter_terms(keys, values, seeds, p,
                                        transform_seeds, lengths, scheme)
    B, n = keys.shape
    table = torch.zeros((B, rows, width + 1), dtype=torch.float32,
                        device=keys.device)  # column ``width``: no cell
    k64 = keys.to(torch.int64)
    for g0 in range(0, n, 32):
        gk, gl = k64[:, g0:g0 + 32], valid[:, g0:g0 + 32]
        is_lead, sums = _lead_sums(gk, vals[:, g0:g0 + 32], gl)
        for r in range(rows):
            salt = hashing.row_salt(seeds[:, None], r)
            bucket = hashing.bucket_hash(gk, salt, width)
            terms = hashing.sign_hash(gk, salt) * sums
            first, d = _lead_sums(bucket, terms, is_lead)
            at = torch.where(first, bucket, width)
            row = table[:, r, :]
            row.scatter_(1, at, row.gather(1, at) + d)
    return table[..., :width].contiguous()


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


def countsketch_update_packed_ref(values, offsets, lengths, rows: int,
                                  width: int, seeds, p: float | None = None,
                                  transform_seeds=None, base_keys=None,
                                  scheme: str = transforms.PPSWOR
                                  ) -> torch.Tensor:
    """CountSketch of B dense segments packed back to back in one (N,)
    vector, stream b's values ``values[offsets[b]:][:lengths[b]]``
    (``lengths`` host ints): (B, rows, width), each stream's table summed
    in slot order, the bits of the same streams padded into rows."""
    B = len(offsets)
    dev = values.device
    seeds, tseeds, _ = stream_params(B, 1, seeds, transform_seeds, None, dev)
    base = hashing.as_u32(0 if base_keys is None else base_keys,
                          device=dev).expand(B)
    out = torch.zeros((B, rows, width), dtype=torch.float32, device=dev)
    for b, (off, n) in enumerate(zip(offsets, lengths)):
        if n:
            out[b] = countsketch_update_batched_ref(
                values[int(off):int(off) + int(n)][None], rows, width,
                seeds[b], p=p, transform_seeds=tseeds[b],
                base_keys=base[b], scheme=scheme)[0]
    return out


def countsketch_update_det_ref(values, rows: int, width: int, seeds,
                               p: float | None = None, transform_seeds=None,
                               base_keys=None, lengths=None,
                               scheme: str = transforms.PPSWOR,
                               chunk: int | None = None) -> torch.Tensor:
    """The deterministic dense update's summation order (csrc/
    countsketch_update.cu, the det variant), in float32: (B, rows, width).

    Stream b's slots fall in chunks of ``chunk`` (a multiple of 32; the
    plan's, ``tiling.table_plan(..., det_chunks=True).chunk``; None: one
    chunk a stream) and in groups of 32 counted from slot 0.  In each
    chunk's table, the live slots of a group that fall in one cell of a row
    sum their signed terms in slot order, d = (t1 + t2) + ..., and the cell,
    from 0.0, takes cell + d, group by group in slot order (the det
    scatter's order: dense keys are distinct, so each slot is its own
    lead).  The delta then sums the chunk tables in chunk order from 0.0.
    With ``p`` set the transform is the plain version's, so only with
    ``p=None`` (or values transformed by the card) does the kernel give
    these bits.  Each cell's terms are folded step by step in a sorted
    order (as many steps as the fullest cell has terms), so the card runs
    it at a layer's size in seconds."""
    keys, seeds, valid, vals = _update_terms(values, seeds, p,
                                             transform_seeds, base_keys,
                                             lengths, scheme)
    B, n = values.shape
    dev = values.device
    chunk = -(-max(n, 1) // 32) * 32 if chunk is None else int(chunk)
    if chunk <= 0 or chunk % 32:
        raise ValueError(f"chunk {chunk}: a positive multiple of 32")
    nch = -(-max(n, 1) // chunk)
    # the live slots alone, stream by stream in slot order
    b_of, slot = valid.nonzero(as_tuple=True)
    keys, vals = keys[valid], vals[valid]
    del valid
    group = slot // 32
    base = (b_of * nch + slot // chunk) * width  # (stream, chunk) table
    ncell = B * nch * width
    table = torch.zeros((B, nch, rows, width), dtype=torch.float32,
                        device=dev)
    for r in range(rows):
        salt = hashing.row_salt(seeds, r)[b_of]
        bucket = hashing.bucket_hash(keys, salt, width)
        term = hashing.sign_hash(keys, salt) * vals
        order = torch.sort(base + bucket, stable=True).indices  # slot order
        cell, term, grp = (base + bucket)[order], term[order], group[order]
        counts = torch.bincount(cell, minlength=ncell)
        starts = torch.cumsum(counts, 0) - counts
        acc = torch.zeros(ncell, dtype=torch.float32, device=dev)
        d = torch.zeros_like(acc)
        last = torch.full((ncell,), -1, dtype=torch.int64, device=dev)
        for k in range(int(counts.max()) if cell.numel() else 0):
            have = counts > k
            at = torch.where(have, starts + k, 0)
            t, g = term[at], grp[at]
            new = have & (g != last)  # the cell's next group: add its d
            acc = torch.where(new, acc + d, acc)
            d = torch.where(new, t, torch.where(have, d + t, d))
            last = torch.where(have, g, last)
        table[:, :, r, :] = (acc + d).view(B, nch, width)
    out = torch.zeros((B, rows, width), dtype=torch.float32, device=dev)
    for c in range(nch):  # chunk order
        out = out + table[:, c]
    return out


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
