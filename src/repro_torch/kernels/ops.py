"""Public entry points of the kernel layer, as the engine calls them.

Each forwards to a kernel wrapper, which launches the CUDA kernel for a
CUDA tensor and uses the plain version for a CPU tensor; nothing here falls
back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core import transforms

from .countsketch_query import (countsketch_estimate,
                                countsketch_estimate_batched,
                                countsketch_query, countsketch_query_batched)
from .countsketch_scatter import countsketch_scatter_batched
from .countsketch_update import countsketch_update, countsketch_update_batched
from . import ref  # noqa: F401  (public re-export, as the reference's)
from .ppswor_transform import ppswor_transform
from .segment_sum import segment_sum as _segment_sum
# the host-side padding arithmetic, re-exported so that callers (the
# packing layer of data.ingest_pipeline) size their buffers to the shapes
# the kernels run; the reference's TPU block constants have no counterpart
from .tiling import packed_span, pad_to  # noqa: F401  (public re-exports)


def sketch_dense_vector(values, rows: int, width: int, seed,
                        p: float | None = None,
                        scheme: str = transforms.PPSWOR, transform_seed=0,
                        base_key=0) -> torch.Tensor:
    """CountSketch of one dense segment, keys ``base_key + i`` -> (rows,
    width), with the fused transform when ``p`` is given."""
    return countsketch_update(values, rows, width, seed, p=p, scheme=scheme,
                              transform_seed=transform_seed,
                              base_key=base_key)


def sketch_dense_batch(values, rows: int, width: int, seeds,
                       p: float | None = None,
                       scheme: str = transforms.PPSWOR, transform_seeds=None,
                       base_keys=None, lengths=None,
                       offsets=None) -> torch.Tensor:
    """CountSketch of B dense segments in one launch -> (B, rows, width);
    ``lengths`` masks ragged streams, or with ``offsets`` the streams lie
    back to back in one packed vector (see countsketch_update_batched)."""
    return countsketch_update_batched(values, rows, width, seeds, p=p,
                                      scheme=scheme,
                                      transform_seeds=transform_seeds,
                                      base_keys=base_keys, lengths=lengths,
                                      offsets=offsets)


def sketch_sparse_vector(keys, values, rows: int, width: int, seed,
                         p: float | None = None,
                         scheme: str = transforms.PPSWOR,
                         transform_seed=0) -> torch.Tensor:
    """Turnstile scatter of one sparse signed (key, value) batch -> (rows,
    width): a B = 1 launch of the batched scatter."""
    return countsketch_scatter_batched(
        keys[None], values[None], rows, width, seed, p=p, scheme=scheme,
        transform_seeds=transform_seed)[0]


def sketch_sparse_batch(keys, values, rows: int, width: int, seeds,
                        p: float | None = None,
                        scheme: str = transforms.PPSWOR,
                        transform_seeds=None, lengths=None) -> torch.Tensor:
    """Turnstile scatter of B sparse signed streams in one launch ->
    (B, rows, width) delta; keys == -1 are padding, ``lengths`` masks
    ragged streams."""
    return countsketch_scatter_batched(keys, values, rows, width, seeds, p=p,
                                       scheme=scheme,
                                       transform_seeds=transform_seeds,
                                       lengths=lengths)


def query_rows(table, keys, seed) -> torch.Tensor:
    """Per-row reads of one table: (rows, k)."""
    return countsketch_query(table, keys, seed)


def query_rows_batched(tables, keys, seeds) -> torch.Tensor:
    """Per-row reads for B streams in one launch: (B, rows, k)."""
    return countsketch_query_batched(tables, keys, seeds)


def estimate(table, keys, seed) -> torch.Tensor:
    """R.Est of one table: (k,) median over rows, one estimate-kernel
    launch."""
    return countsketch_estimate(table, keys, seed)


def estimate_batched(tables, keys, seeds) -> torch.Tensor:
    """Batched R.Est: (B, k) median over rows (``jnp.median`` semantics),
    one estimate-kernel launch that takes the median in registers -- the
    engine's single query chokepoint."""
    return countsketch_estimate_batched(tables, keys, seeds)


def transform(keys, values, p: float, transform_seed) -> torch.Tensor:
    """Standalone p-ppswor transform (Eq. 5) in the values' type."""
    return ppswor_transform(keys, values, p, transform_seed)


def segment_sum(values, seg) -> torch.Tensor:
    """Per-row sums over runs of equal, nondecreasing segment ids, each run
    added in index order: one launch of the sorted segment-sum kernel."""
    return _segment_sum(values, seg)
