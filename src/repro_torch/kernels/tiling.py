"""Launch geometry shared by the CUDA kernel wrappers (Hopper).

The JAX package tiled its Pallas grids by the TPU's (8, 128) vector
registers and sized blocks for VMEM.  The port's kernels are element-wise
over a flat index (one thread per (stream, element) or (stream, key)), so
all they need is a block size and a 1-D grid over the items.
"""
from __future__ import annotations

# 8 warps: enough threads in flight per SM to hide the random-access
# latency of the scatter/gather while keeping register use per block low.
THREADS_PER_BLOCK = 256
MAX_GRID_X = 2**31 - 1


def pad_to(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def grid_1d(items: int, threads: int = THREADS_PER_BLOCK) -> int:
    """Blocks of ``threads`` covering ``items`` flat work items."""
    blocks = pad_to(items, threads) // threads
    if blocks > MAX_GRID_X:
        raise ValueError(f"{items} items need {blocks} blocks, above the "
                         f"grid limit {MAX_GRID_X}")
    return blocks
