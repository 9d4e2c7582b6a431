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
_INT_MAX = 2**31 - 1
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
# The deterministic scatter (csrc/smem_table.cuh det_table_block): 8
# producer warps, one a 32-slot group of each stage of DET_STAGE slots, and
# a walker warp a row, at most DET_MAX_WALKERS; two stages (each slot's
# value and, for every row, its bucket and sign in ``det_entry_bytes``)
# beside the table.
DET_STAGE = 256
DET_PRODUCERS = DET_STAGE // 32
DET_MAX_WALKERS = 8
# The deterministic dense update (csrc/smem_table.cuh det_dense_block): a
# warp a row, at most DENSE_MAX_WARPS (warp w takes rows w, w + 8, ...),
# over a double-buffered stage of DENSE_SLOTS_PER_THREAD x threads
# transformed values beside the table.  Its chunks are cut for
# DET_DENSE_BLOCKS_PER_SM blocks an SM: three waves of the 3 blocks
# (64,512 B each) that an SM holds at the defaults.
DENSE_MAX_WARPS = 8
DENSE_SLOTS_PER_THREAD = 4
DET_DENSE_BLOCKS_PER_SM = 9
# A det table too large for one block is spread over a thread block
# cluster (csrc/smem_table.cuh det_cluster_block): at most
# DET_MAX_CLUSTER CTAs (the portable limit), each a slice small enough
# that two of them, with the 1 KB the card reserves a block, fit an SM's
# shared memory.
DET_MAX_CLUSTER = 8
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
# A cluster CTA has DET_PRODUCERS producer warps (a 32-slot group of its
# DET_STAGE slots each) and a walker warp a row; each producer tests each
# row's leads for a shared bucket in a bitmap of DET_CLASH_BITS bits at
# most (exact up to that many buckets), at least DET_CLASH_MIN_BITS.
DET_CLASH_BITS = 16_384
DET_CLASH_MIN_BITS = 1_024
# The quantum of a packed host block (``data.ingest_pipeline.PackedBatcher``):
# a whole number of the shared-memory scatter's passes (``TABLE_THREADS``
# slots; every chunk of ``table_plan`` is a multiple of it) and of the
# deterministic scatter's stage (``DET_STAGE`` slots), so a full block costs
# no partial pass on either variant.
PACK_QUANTUM = 1024
# The sorted segment sum (csrc/segment_sum.cu): blocks of SEGMENT_THREADS
# walking their rows in tiles of SEGMENT_TILE slots.  The kernel's own
# constants; the wrapper passes both, and the kernel refuses a launch
# whose geometry is not its own.
SEGMENT_THREADS = 256
SEGMENT_TILE = 1024


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


# The row read (csrc/countsketch_query.cu): threads an SM holds (H100:
# 2048); reads within one wave of the card's threads take a lane each.
THREADS_PER_SM = 2048
ROW_READ_LANES, ROW_READ_KEYS = 1, 0  # its two layouts


def row_read_launch(B: int, rows: int, k: int,
                    sm_count: int) -> tuple[int, int, int]:
    """(blocks, threads, layout) of the row read of B streams' k keys in
    ``rows`` rows.  Where the B x rows x k reads fit one wave of the
    card's threads, ``ROW_READ_LANES``, a lane a read: a block a stream's
    tile of 32 keys, a warp a row (32 warps at most; more rows loop).
    Past it, ``ROW_READ_KEYS``, a lane a key, its rows' loads in flight
    together, 256 threads a block."""
    if B * rows * k <= sm_count * THREADS_PER_SM:
        blocks = B * (-(-k // 32))
        if blocks > MAX_GRID_X:
            raise ValueError(f"the row read of {B} x {k} keys needs {blocks} "
                             f"blocks, above the grid limit {MAX_GRID_X}")
        return blocks, 32 * min(rows, 32), ROW_READ_LANES
    return grid_1d(B * k), THREADS_PER_BLOCK, ROW_READ_KEYS


def lengths_arg(lengths, B: int, n: int, device) -> torch.Tensor:
    """A kernel's (B,) int32 stream lengths, clamped to [0, n] (None means
    n).  A scalar is filled on the device, and host lengths cross from
    pinned memory without waiting, so no blocking host-to-device copy
    precedes the launch."""
    if not isinstance(lengths, torch.Tensor):
        lens = np.clip(np.asarray(n if lengths is None else lengths,
                                  np.int64), 0, n)
        if lens.ndim == 0:
            return torch.full((B,), int(lens), dtype=torch.int32,
                              device=device)
        lengths = torch.from_numpy(lens.astype(np.int32))
        if torch.device(device).type == "cuda":
            return lengths.pin_memory().to(device, non_blocking=True) \
                .expand(B).contiguous()
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
    (under ``torch.use_deterministic_algorithms(True)``): every cell summed
    in an order fixed by the slot indices.  The scatter's is one block per
    stream (``chunk`` is then the stage): producer warps hash stages of
    ``DET_STAGE`` slots and a warp a row adds them.  The dense update's is
    cut into chunks as "smem" is, each block a warp a row that hashes and
    adds its row (``det_dense_threads``), each chunk's table summed into
    the delta in chunk order by a second pass unless ``one_per_stream``.
    A "det" table too large for one block is split (``det_split``): each
    stream (scatter) or chunk (dense) gets ``det_parts`` blocks, each
    owning ``row_group`` consecutive rows, or, where ``ranges`` > 1, one
    bucket range of one row; ``blocks`` counts them all (0 and 1: one
    block holds the whole table).  Where ``cluster`` > 0 those parts are
    the CTAs of one thread block cluster (``det_cluster``), which hash
    each slot once for all of them; 0: each part a block of its own that
    hashes every slot."""
    variant: str
    blocks: int
    threads: int
    chunk: int = 0
    one_per_stream: bool = False
    smem_bytes: int = 0
    row_group: int = 0
    ranges: int = 1
    cluster: int = 0


def table_fits(rows: int, width: int) -> bool:
    """Whether a float32 rows x width table fits one block's shared
    memory."""
    return rows * width * 4 <= SMEM_PER_BLOCK_OPTIN


def det_entry_bytes(width: int) -> int:
    """Bytes of a staged (bucket, sign) entry of the deterministic scatter:
    16 bits (15 of bucket, the sign) where ``width <= 2**15``, else 32."""
    return 2 if width <= 2**15 else 4


def det_threads(rows: int) -> int:
    """Threads of a deterministic scatter block: the producers and a
    walker a row."""
    return 32 * (DET_PRODUCERS + min(rows, DET_MAX_WALKERS))


def det_smem_bytes(rows: int, width: int) -> int:
    """Shared memory of a deterministic scatter block: the table and two
    stages (csrc/smem_table.cuh det_stage_bytes)."""
    stage = DET_STAGE * 4 + DET_PRODUCERS * 4 \
        + rows * DET_STAGE * det_entry_bytes(width)
    return rows * width * 4 + 2 * stage


def det_fits(rows: int, width: int) -> bool:
    """Whether one deterministic scatter block holds this whole table (a
    larger one is split, ``det_split``)."""
    return det_smem_bytes(rows, width) <= SMEM_PER_BLOCK_OPTIN


def det_dense_threads(rows: int) -> int:
    """Threads of a deterministic dense-update block: a warp a row, at most
    ``DENSE_MAX_WARPS``."""
    return 32 * min(rows, DENSE_MAX_WARPS)


def det_dense_stage(rows: int) -> int:
    """Slots of the deterministic dense update's stage: a multiple of
    ``4 x 32`` (the groups a lane hashes ahead)."""
    return DENSE_SLOTS_PER_THREAD * det_dense_threads(rows)


def det_dense_smem_bytes(rows: int, width: int) -> int:
    """Shared memory of a deterministic dense-update block: the table and
    two stages of float32 values."""
    return rows * width * 4 + 2 * 4 * det_dense_stage(rows)


def det_dense_fits(rows: int, width: int) -> bool:
    """Whether one deterministic dense-update block holds this whole
    table: rows x width x 4 B plus 2,048 B a row-owning warp within a
    block's 232,448 B, so width <= 8,045 at rows 7 (8,301 for the
    shared-memory atomics) and <= 57,856 at rows 1; a larger table is
    split (``det_split``)."""
    return det_dense_smem_bytes(rows, width) <= SMEM_PER_BLOCK_OPTIN


def det_split(rows: int, width: int, smem_bytes) -> tuple[int, int]:
    """How a deterministic kernel splits a rows x width table whose block
    needs ``smem_bytes(rows, width)`` of shared memory: (0, 1) where one
    block holds it; else (g, 1), row groups of the most consecutive rows
    ``g`` whose table slice and stages fit a block; else, where one row
    does not fit, (1, q), each row cut into ``q`` equal bucket ranges of
    ``det_span`` buckets, as few as fit.  The order fixes a cell's terms
    only within its row, and every lead of one bucket falls in one range,
    so a split table holds the bits that one block would give."""
    if smem_bytes(rows, width) <= SMEM_PER_BLOCK_OPTIN:
        return 0, 1
    group = max((g for g in range(1, rows) if smem_bytes(g, width)
                 <= SMEM_PER_BLOCK_OPTIN), default=0)
    if group:
        return group, 1
    ranges = 2
    while smem_bytes(1, -(-width // ranges)) > SMEM_PER_BLOCK_OPTIN:
        ranges += 1
    return 1, ranges


def det_cluster_smem_bytes(parts: int, srows: int, span: int,
                           clash_bits: int = DET_CLASH_MIN_BITS) -> int:
    """Shared memory of a CTA of a ``parts``-CTA det cluster: its slice,
    ``srows`` rows of ``span`` buckets; two inbox stages, which hold for
    each of its rows and every CTA's ``DET_STAGE`` slots a live mask a
    group, a float32 term and a bucket a slot
    (``det_bucket_bytes``: counted from the slice's first; csrc/
    smem_table.cuh det_inbox_bytes); and a bitmap of ``clash_bits`` bits
    a producer warp."""
    inbox = parts * srows * (DET_PRODUCERS * 4 + DET_STAGE * 4
                             + DET_STAGE * det_bucket_bytes(span))
    return srows * span * 4 + 2 * inbox + DET_PRODUCERS * clash_bits // 8


def det_bucket_bytes(span: int) -> int:
    """Bytes of a bucket in a det cluster CTA's inbox: 16 bits where its
    slice spans at most 2**16 buckets, else 32."""
    return 2 if span <= 2**16 else 4


def _cluster_ctas_per_sm(smem: int) -> int:
    return SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)


def det_cluster(rows: int, width: int,
                scatter: bool = False) -> tuple[int, int]:
    """How a thread block cluster holds a rows x width det table too large
    for one block: (g, 1), each CTA a row group of ``g`` rows, the fewest
    that keep the cluster within ``DET_MAX_CLUSTER`` CTAs; else, where one
    row per CTA does not fit, (1, q), each of the rows cut into ``q =
    DET_MAX_CLUSTER // rows`` equal bucket ranges; (0, 1) where neither
    keeps two CTAs an SM (such a table takes ``det_split``'s blocks).  A
    CTA's slice, inbox and least bitmaps fit twice in ``SMEM_PER_SM``
    with the reserve of each.

    The scatter (``scatter``), whose streams are a few cluster stages
    long, takes a cluster only of row groups that fit three CTAs an SM:
    on the card its clusters of two CTAs an SM (7 x 16,384) and of bucket
    ranges (1 x 100,000) were slower than ``det_split``'s blocks, which
    it keeps there (``chip_smoke.py --det-parent``, PERF.md)."""
    least = 3 if scatter else 2

    def fits(parts, srows, span):
        return _cluster_ctas_per_sm(
            det_cluster_smem_bytes(parts, srows, span)) >= least

    group = -(-rows // DET_MAX_CLUSTER)
    if fits(-(-rows // group), group, width):
        return group, 1
    ranges = DET_MAX_CLUSTER // rows
    if not scatter and group == 1 and ranges > 1 and fits(
            rows * ranges, 1, -(-width // ranges)):
        return 1, ranges
    return 0, 1


def _clash_bits(parts: int, srows: int, span: int, width: int) -> int:
    """The bits of a cluster CTA's producer bitmaps: the most, up to
    ``DET_CLASH_BITS`` and the power of two that covers ``width``, that
    keep as many CTAs an SM as the least do."""
    least = _cluster_ctas_per_sm(det_cluster_smem_bytes(parts, srows, span))
    bits = DET_CLASH_BITS
    while bits > DET_CLASH_MIN_BITS and (
            bits >= 2 * width or _cluster_ctas_per_sm(
                det_cluster_smem_bytes(parts, srows, span, bits)) < least):
        bits //= 2
    return bits


def det_clash_bits(plan: TablePlan, width: int) -> int:
    """The clash bitmaps' bits of a cluster plan's CTAs (``_clash_bits``;
    the kernel's argument, and part of ``plan.smem_bytes``)."""
    return _clash_bits(plan.cluster, plan.row_group, det_span(plan, width),
                       width)


def det_span(plan: TablePlan, width: int) -> int:
    """Buckets a row slice of a "det" block spans: ``width``, or a bucket
    range's (the last range may be narrower)."""
    return -(-width // plan.ranges) if plan.ranges > 1 else width


def det_parts(plan: TablePlan, rows: int) -> int:
    """Blocks a "det" plan gives each stream (scatter) or chunk (dense)."""
    if plan.ranges > 1:
        return rows * plan.ranges
    return -(-rows // plan.row_group) if plan.row_group else 1


def det_cuts(plan: TablePlan, rows: int, width: int) -> np.ndarray:
    """The (parts, 4) [first row, end row, first bucket, end bucket) of
    each block of one stream or chunk of a "det" plan, as the kernel
    derives them from ``blockIdx.x % parts`` (csrc/smem_table.cuh
    det_part)."""
    if plan.ranges > 1:
        span = det_span(plan, width)
        part = np.arange(rows * plan.ranges)
        r0, w0 = part // plan.ranges, part % plan.ranges * span
        return np.stack([r0, r0 + 1, w0, np.minimum(w0 + span, width)], 1)
    group = plan.row_group or rows
    r0 = np.arange(0, rows, group)
    return np.stack([r0, np.minimum(r0 + group, rows),
                     np.zeros_like(r0), np.full_like(r0, width)], 1)


def det_plan_blocks(plan: TablePlan, lengths, rows: int,
                    width: int) -> np.ndarray:
    """The (blocks, 7) [stream, first slot, end slot, first row, end row,
    first bucket, end bucket) of a "det" plan: block g serves part ``g %
    parts`` (``det_cuts``) of stream or chunk ``g // parts``, whose slots
    are as ``plan_blocks`` gives them (a whole stream where each stream is
    one block)."""
    parts = det_parts(plan, rows)
    lens = np.asarray(lengths, np.int64)
    if plan.one_per_stream:
        spans = np.stack([np.arange(len(lens)), np.zeros_like(lens), lens],
                         1)
    else:
        spans = plan_blocks(plan._replace(blocks=plan.blocks // parts), lens)
    cuts = det_cuts(plan, rows, width)
    return np.concatenate([np.repeat(spans, parts, 0),
                           np.tile(cuts, (len(spans), 1))], 1)


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


def _chunked_plan(variant: str, B: int, lengths, rows: int, width: int,
                  sm_count: int, threads: int, smem: int,
                  blocks_per_sm: int = TABLE_BLOCKS_PER_SM,
                  quantum: int = TABLE_THREADS) -> TablePlan:
    """A plan of one block per (stream, chunk) holding live slots (see
    ``table_plan``)."""
    lens = np.asarray(lengths, np.int64)
    live = int(lens.sum())
    want = -(-live // (blocks_per_sm * sm_count))
    least = min(4 * rows * width, -(-live // sm_count))
    chunk = pad_to(max(want, least, 1), quantum)
    if chunk >= int(lens.max(initial=0)):
        return TablePlan(variant, B, threads, chunk, True, smem)
    blocks = int(block_ends(lens, chunk)[-1])
    if blocks > MAX_GRID_X:
        raise ValueError(f"{blocks} blocks exceed the grid limit "
                         f"{MAX_GRID_X}")
    return TablePlan(variant, blocks, threads, chunk, False, smem)


def _det_plan(plan: TablePlan, rows: int, width: int, threads,
              smem_bytes, scatter: bool) -> TablePlan:
    """``plan`` (one block a stream or chunk holding the whole table) split
    where the table does not fit a block: over a thread block cluster
    (``det_cluster``), each CTA a producer-and-walker block
    (``det_threads``) with its slice, inbox and bitmaps; past a cluster,
    by ``det_split``, each block's threads and shared memory those of its
    row group (a bucket range: one row of ``det_span`` buckets).  The
    blocks are multiplied by the parts."""
    if rows * width > _INT_MAX:
        raise ValueError(f"deterministic mode: a {rows} x {width} table has "
                         f"more cells than the kernels index ({_INT_MAX})")
    group, ranges = det_split(rows, width, smem_bytes)
    if not group:
        return plan
    cgroup, cranges = det_cluster(rows, width, scatter)
    if cgroup:
        group, ranges = cgroup, cranges
    plan = plan._replace(row_group=group, ranges=ranges)
    parts = det_parts(plan, rows)
    blocks = plan.blocks * parts
    if blocks > MAX_GRID_X:
        raise ValueError(f"deterministic mode: the {rows} x {width} table "
                         f"split {parts} ways needs {blocks} blocks, above "
                         f"the grid limit {MAX_GRID_X}")
    srows, span = group, det_span(plan, width)
    if cgroup:
        return plan._replace(blocks=blocks, threads=det_threads(srows),
                             smem_bytes=det_cluster_smem_bytes(
                                 parts, srows, span, _clash_bits(
                                     parts, srows, span, width)),
                             cluster=parts)
    return plan._replace(blocks=blocks, threads=threads(srows),
                         smem_bytes=smem_bytes(srows, span))


def table_plan(B: int, n: int, lengths, rows: int, width: int,
               sm_count: int, variant: str | None = None,
               deterministic: bool = False,
               det_chunks: bool = False) -> TablePlan:
    """The launch of a summing kernel over B streams of n slots, stream b
    live in ``[0, lengths[b])`` (host (B,) ints, already clamped to
    [0, n]), for a ``sm_count``-SM card.

    The variant follows from the mode and the shape: "det" when
    ``deterministic`` (a summing kernel under PyTorch's deterministic mode;
    a table too large for one block is split across blocks by rows or
    bucket ranges, ``det_split``), else "smem" exactly when the rows x
    width float32 table fits a block's shared memory, else "global";
    ``variant`` forces one (forcing "smem" on a table that does not fit
    raises).  "det" is one block a stream, or with ``det_chunks`` (the
    dense update) cut into chunks as "smem" is, and then ``lengths`` is
    read.  The chunk is the live slots over ``TABLE_BLOCKS_PER_SM`` x
    ``sm_count`` blocks, and a multiple of the block's threads (the dense
    "det": over ``DET_DENSE_BLOCKS_PER_SM`` x ``sm_count`` blocks, and a
    multiple of its stage; both of the whole table's shape, split or not).
    It is at
    least four tables' cells (so a block's flush, one add a cell, is under
    4 % of its rows adds a slot), unless that would leave SMs without a
    block: then at least the live slots over ``sm_count``.  Where one chunk
    holds the longest stream, each stream is one block."""
    fits = table_fits(rows, width)
    if variant is None:
        variant = "det" if deterministic else "smem" if fits else "global"
    if variant == "global":  # ``lengths`` is not read (it may be None)
        return TablePlan("global", grid_1d(B * n), THREADS_PER_BLOCK)
    if variant == "det" and det_chunks:
        plan = _chunked_plan("det", B, lengths, rows, width, sm_count,
                             det_dense_threads(rows),
                             det_dense_smem_bytes(rows, width),
                             DET_DENSE_BLOCKS_PER_SM, det_dense_stage(rows))
        return _det_plan(plan, rows, width, det_dense_threads,
                         det_dense_smem_bytes, scatter=False)
    if variant == "det":
        if B > MAX_GRID_X:  # ``lengths`` is not read: each stream is a block
            raise ValueError(f"{B} blocks exceed the grid limit {MAX_GRID_X}")
        plan = TablePlan("det", B, det_threads(rows), DET_STAGE, True,
                         det_smem_bytes(rows, width))
        return _det_plan(plan, rows, width, det_threads, det_smem_bytes,
                         scatter=True)
    if variant != "smem":
        raise ValueError(f"unknown kernel variant {variant!r}")
    if not fits:
        raise ValueError(f"a {rows} x {width} float32 table "
                         f"({rows * width * 4} B) does not fit the "
                         f"{SMEM_PER_BLOCK_OPTIN} B of shared memory of a "
                         f"block")
    return _chunked_plan("smem", B, lengths, rows, width, sm_count,
                         TABLE_THREADS, rows * width * 4)


def sm_count(device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def table_launch(B: int, n: int, lengths, rows: int, width: int, device,
                 variant: str | None = None, deterministic: bool = False,
                 det_chunks: bool = False):
    """The plan of a summing kernel's launch on the card ``device`` and its
    (B, rows, width) float32 delta: ``torch.empty`` where the launch writes
    every cell (each stream's one block, or the det variant's second pass),
    else zeroed.  Host lengths are read only for a chunked plan (a CUDA
    tensor of lengths waits for the card).  Under PyTorch's deterministic
    mode ``torch.empty`` fills the delta with NaN first
    (``torch.utils.deterministic.fill_uninitialized_memory``), which the
    kernel then overwrites."""
    if variant is None:
        variant = "det" if deterministic \
            else "smem" if table_fits(rows, width) else "global"
    chunked = variant == "smem" or (variant == "det" and det_chunks)
    lens = host_lengths(lengths, B, n) if chunked else None
    plan = table_plan(B, n, lens, rows, width, sm_count(device), variant,
                      det_chunks=det_chunks)
    alloc = torch.empty if plan.one_per_stream or plan.variant == "det" \
        else torch.zeros
    return plan, alloc((B, rows, width), dtype=torch.float32, device=device)


class SegmentPlan(NamedTuple):
    """Launch of the sorted segment sum over ``rows`` rows of ``n`` slots:
    block g (of ``SEGMENT_THREADS`` threads) takes rows
    [g * rows_per_block, (g + 1) * rows_per_block) (the last block fewer),
    walked as one range in tiles of ``SEGMENT_TILE`` slots, in order."""
    rows_per_block: int
    blocks: int


def segment_plan(rows: int, n: int) -> SegmentPlan:
    """The segment sum's launch: a block a row where a row fills a tile or
    more (a long row is walked tile by tile, a run that crosses a tile
    carried over in order), else as many whole rows as fit one tile."""
    if rows < 1 or n < 1:
        raise ValueError(f"segment sum over {rows} rows of {n} slots")
    per = max(1, SEGMENT_TILE // n)
    blocks = -(-rows // per)
    if blocks > MAX_GRID_X:
        raise ValueError(f"{blocks} blocks exceed the grid limit {MAX_GRID_X}")
    return SegmentPlan(per, blocks)
