"""Launch geometry shared by the CUDA kernel wrappers (Hopper).

The JAX package tiled its Pallas grids by the TPU's (8, 128) vector
registers and sized blocks for VMEM.  The port's kernels are element-wise
over a flat index (one thread per (stream, element) or (stream, key)), so
all they need is a block size and a 1-D grid over the items.
"""
from __future__ import annotations

import numpy as np
import torch

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


def lengths_arg(lengths, B: int, n: int, device) -> torch.Tensor:
    """A kernel's (B,) int32 stream lengths, clamped to [0, n] (None means
    n).  A scalar is filled on the device, so no blocking host-to-device
    copy precedes the launch."""
    if not isinstance(lengths, torch.Tensor):
        lens = np.clip(np.asarray(n if lengths is None else lengths,
                                  np.int64), 0, n)
        if lens.ndim == 0:
            return torch.full((B,), int(lens), dtype=torch.int32,
                              device=device)
        lengths = torch.from_numpy(lens)
    return lengths.to(device=device, dtype=torch.int64).clamp(0, n).to(
        torch.int32).expand(B).contiguous()
