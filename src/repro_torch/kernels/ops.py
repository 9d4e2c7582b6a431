"""Public entry points of the kernel layer, as the engine calls them.

Each forwards to a kernel wrapper, which launches the CUDA kernel for a
CUDA tensor and uses the plain version for a CPU tensor; nothing here falls
back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core import countsketch, transforms

from .countsketch_query import countsketch_query_batched
from .countsketch_scatter import countsketch_scatter_batched


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


def query_rows_batched(tables, keys, seeds) -> torch.Tensor:
    """Per-row reads for B streams in one launch: (B, rows, k)."""
    return countsketch_query_batched(tables, keys, seeds)


def estimate_batched(tables, keys, seeds) -> torch.Tensor:
    """Batched R.Est: (B, k) median over rows (``jnp.median`` semantics) of
    one query launch -- the engine's single query chokepoint."""
    return countsketch.median(query_rows_batched(tables, keys, seeds), 1)
