"""Launch geometry shared by the CUDA kernel wrappers (Hopper).

The JAX package tiled its Pallas grids by the TPU's (8, 128) vector
registers and sized blocks for VMEM.  The port's query and transform
kernels are element-wise over a flat index (one thread per (stream,
element) or (stream, key)), so all they need is a block size and a 1-D grid
over the items.  The summing kernels (scatter, dense update) keep each
block's rows x width table in shared memory; ``table_plan`` cuts their
streams into chunks, one block each.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# 8 warps: enough threads in flight per SM to hide the random-access
# latency of the scatter/gather while keeping register use per block low.
THREADS_PER_BLOCK = 256
MAX_GRID_X = 2**31 - 1
# The shared-memory table kernels: 16 warps a block, so that the 4 blocks
# whose 57 KB tables fit in an SM's 228 KB bring its full 2048 threads
# (csrc/smem_table.cuh).
TABLE_THREADS = 512
# Dynamic shared memory one block may opt in to on Hopper (227 KB).
SMEM_PER_BLOCK_OPTIN = 232_448
# A chunk is sized so that the live slots make about this many blocks per
# SM: two waves of the 4 resident blocks, so the ragged last wave and
# uneven streams cost little.
TABLE_BLOCKS_PER_SM = 8
# The deterministic scatter (csrc/smem_table.cuh det_table_block): one warp
# a row, at most DET_MAX_WARPS, and a stage of DET_TILE slots (key and
# transformed value, 8 B each) beside the table.
DET_TILE = 1024
DET_MAX_WARPS = 16
# The quantum of a packed host block (``data.ingest_pipeline.PackedBatcher``):
# a whole number of the shared-memory scatter's passes (``TABLE_THREADS``
# slots; every chunk of ``table_plan`` is a multiple of it) and of the
# deterministic scatter's stage (``DET_TILE`` slots), so a full block costs
# no partial pass on either variant.
PACK_QUANTUM = DET_TILE


def pad_to(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def packed_span(n: int) -> int:
    """Slots of a fixed-shape host block covering ``n`` events: ``n``
    rounded up to a whole number of ``PACK_QUANTUM``."""
    return pad_to(max(int(n), 1), PACK_QUANTUM)


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


class TablePlan(NamedTuple):
    """Launch of a summing kernel.

    ``variant`` "smem": one block per (stream, chunk of ``chunk`` slots),
    its table in ``smem_bytes`` of shared memory.  With ``one_per_stream``
    every stream, even an empty one, gets exactly one block, which owns the
    stream's delta and writes every cell with plain stores; otherwise only
    the chunks that hold live slots get a block, and each adds its table
    into a zeroed delta.  "global": one thread per slot with global atomics
    into a zeroed delta, for tables too large for shared memory.  "det"
    (the scatter under ``torch.use_deterministic_algorithms(True)``): one
    block per stream, one warp a row, the stream walked in stages of
    ``chunk`` slots, every cell summed in an order fixed by slot index."""
    variant: str
    blocks: int
    threads: int
    chunk: int = 0
    one_per_stream: bool = False
    smem_bytes: int = 0


def table_fits(rows: int, width: int) -> bool:
    """Whether a float32 rows x width table fits one block's shared
    memory."""
    return rows * width * 4 <= SMEM_PER_BLOCK_OPTIN


def det_smem_bytes(rows: int, width: int) -> int:
    """Shared memory of a deterministic scatter block: the table and its
    stage of ``DET_TILE`` keys and values."""
    return rows * width * 4 + DET_TILE * 8


def det_fits(rows: int, width: int) -> bool:
    """Whether the deterministic scatter has a variant for this table."""
    return det_smem_bytes(rows, width) <= SMEM_PER_BLOCK_OPTIN


def host_lengths(lengths, B: int, n: int) -> np.ndarray:
    """(B,) int64 stream lengths on the host, clamped to [0, n] (None means
    n).  A CUDA tensor is read back, which waits for the card."""
    if lengths is None:
        lengths = n
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu().numpy()
    lens = np.clip(np.asarray(lengths, np.int64), 0, n)
    return np.broadcast_to(lens, (B,)).copy()


def block_ends(lengths, chunk: int):
    """Inclusive prefix sum over the streams of their chunk counts
    ceil(lengths[b] / chunk): block g of a chunked launch serves the first
    stream b with ``g < ends[b]``.  numpy in, numpy out; a tensor in gives
    an int32 tensor on its device (no copy between host and card)."""
    if isinstance(lengths, torch.Tensor):
        lens = lengths.to(torch.int64)
        return torch.cumsum((lens + chunk - 1) // chunk, 0).to(torch.int32)
    lens = np.asarray(lengths, np.int64)
    return np.cumsum((lens + chunk - 1) // chunk)


def plan_blocks(plan: TablePlan, lengths: np.ndarray) -> np.ndarray:
    """The (blocks, 3) [stream, first slot, end slot) of a "smem" plan, as
    the kernel derives them from ``blockIdx.x`` (its binary search over
    ``block_ends`` is ``searchsorted(..., side="right")``)."""
    lens = np.asarray(lengths, np.int64)
    g = np.arange(plan.blocks, dtype=np.int64)
    if plan.one_per_stream:
        b, start = g, np.zeros_like(g)
    else:
        ends = block_ends(lens, plan.chunk)
        b = np.searchsorted(ends, g, side="right")
        start = (g - np.concatenate([[0], ends])[b]) * plan.chunk
    return np.stack([b, start, np.minimum(start + plan.chunk, lens[b])], 1)


def table_plan(B: int, n: int, lengths, rows: int, width: int,
               sm_count: int, variant: str | None = None,
               deterministic: bool = False) -> TablePlan:
    """The launch of a summing kernel over B streams of n slots, stream b
    live in ``[0, lengths[b])`` (host (B,) ints, already clamped to
    [0, n]), for a ``sm_count``-SM card.

    The variant follows from the mode and the shape: "det" when
    ``deterministic`` (the scatter under PyTorch's deterministic mode; a
    table too large for it raises, naming the shape: there is no
    deterministic fallback), else "smem" exactly when the rows x width
    float32 table fits a block's shared memory, else "global"; ``variant``
    forces one (forcing "smem" or "det" on a table that does not fit
    raises).  The chunk is the live slots over ``TABLE_BLOCKS_PER_SM`` x
    ``sm_count`` blocks, and a multiple of the block's threads.  It is at
    least four tables' cells (so a block's flush, one add a cell, is under
    4 % of its rows adds a slot), unless that would leave SMs without a
    block: then at least the live slots over ``sm_count``.  Where one chunk
    holds the longest stream, each stream is one block."""
    fits = table_fits(rows, width)
    if variant is None:
        variant = "det" if deterministic else "smem" if fits else "global"
    if variant == "global":  # ``lengths`` is not read (it may be None)
        return TablePlan("global", grid_1d(B * n), THREADS_PER_BLOCK)
    if variant == "det":  # nor here: each stream is one block
        if not det_fits(rows, width):
            raise ValueError(
                f"deterministic mode: the scatter's {rows} x {width} float32 "
                f"table and its {DET_TILE}-slot stage "
                f"({det_smem_bytes(rows, width)} B) do not fit the "
                f"{SMEM_PER_BLOCK_OPTIN} B of shared memory of a block, and "
                f"the deterministic scatter has no variant for a larger "
                f"table")
        if B > MAX_GRID_X:
            raise ValueError(f"{B} blocks exceed the grid limit {MAX_GRID_X}")
        return TablePlan("det", B, 32 * min(rows, DET_MAX_WARPS), DET_TILE,
                         True, det_smem_bytes(rows, width))
    if variant != "smem":
        raise ValueError(f"unknown kernel variant {variant!r}")
    if not fits:
        raise ValueError(f"a {rows} x {width} float32 table "
                         f"({rows * width * 4} B) does not fit the "
                         f"{SMEM_PER_BLOCK_OPTIN} B of shared memory of a "
                         f"block")
    lens = np.asarray(lengths, np.int64)
    live = int(lens.sum())
    want = -(-live // (TABLE_BLOCKS_PER_SM * sm_count))
    least = min(4 * rows * width, -(-live // sm_count))
    chunk = pad_to(max(want, least, 1), TABLE_THREADS)
    smem = rows * width * 4
    if chunk >= int(lens.max(initial=0)):
        return TablePlan("smem", B, TABLE_THREADS, chunk, True, smem)
    blocks = int(block_ends(lens, chunk)[-1])
    if blocks > MAX_GRID_X:
        raise ValueError(f"{blocks} blocks exceed the grid limit "
                         f"{MAX_GRID_X}")
    return TablePlan("smem", blocks, TABLE_THREADS, chunk, False, smem)


def sm_count(device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def table_launch(B: int, n: int, lengths, rows: int, width: int, device,
                 variant: str | None = None, deterministic: bool = False):
    """The plan of a summing kernel's launch on the card ``device`` and its
    (B, rows, width) float32 delta: ``torch.empty`` where each stream's one
    block writes its delta whole, else zeroed.  Host lengths are read only
    for the shared-memory variant (a CUDA tensor of lengths waits for the
    card).  Under PyTorch's deterministic mode ``torch.empty`` fills the
    delta with NaN first (``torch.utils.deterministic.
    fill_uninitialized_memory``), which the kernel then overwrites."""
    if variant is None:
        variant = "det" if deterministic \
            else "smem" if table_fits(rows, width) else "global"
    lens = host_lengths(lengths, B, n) if variant == "smem" else None
    plan = table_plan(B, n, lens, rows, width, sm_count(device), variant)
    alloc = torch.empty if plan.one_per_stream else torch.zeros
    return plan, alloc((B, rows, width), dtype=torch.float32, device=device)
