#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Seven paths, each driven with the kernels' launch counts set to 0 just
before it and read just after:

* Sparse plane.  Per-key analytics over B = 4096 independent turnstile
  streams (one per tenant or request) at the engine's defaults -- rows 7,
  width 2048, 512 candidates, p = 1, ppswor, FlushPolicy(max_elems=4096).
  Stream b is ``TurnstileZipfStream(vocab_size=2**20, alpha=1.2,
  delete_fraction=0.25)`` shard b: 4096 inserts plus 1024 retractions per
  step.  Eight steps are ingested, then ``sample(k=64)``.  Device state:
  4096 x 7 x 2048 x 4 B = 235 MB of tables.
* Dense segments.  ``SketchEngine.update_dense`` on the per-layer gradient
  streams of one gemma2_2b decoder layer, one stream per parameter leaf (the
  shape of ``gradcomp.tree_compress_step_engine``): 11 streams, 77.9 M live
  elements a step, 4 steps, then ``sample(k=32)``.  Depth is cut to 1 layer
  of 26; the widths are the published ones.
* Single-stream entry points.  ``ops.sketch_dense_vector`` at n = 1 M and at
  one gemma2_2b ``wg`` leaf (21.2 M), ``ops.query_rows``/``ops.estimate``
  with 512 keys, ``ops.transform`` in float32 and bfloat16 (the shapes of
  benchmarks/sketch_throughput.py), and ``ops.query_rows_batched`` (the
  per-row reads of those two tables).
* Samplers.  The sparse plane's stream and engine defaults (B = 4096,
  capacity 512, 8 cascade samplers) through the other samplers:
  ``twopass`` (ingest, ``sample(k=64)``), ``tv`` (ingest, ``sample(k=8)``),
  ``onepass`` with ``freeze``, 8 ``update_pass2`` calls and
  ``sample_exact(k=64)``, and the ``perfect`` oracle (domain 2**20) on the
  first 256 streams.  After each flush the first 256 streams are held
  against the plain update of the state before it (the kernel path's
  state, so that a near tie swapped once does not carry over); tables
  within both bounds, candidate and pass-II keys identical but for near
  ties, exact frequencies equal.  Cut: the plain reference runs on 256 of
  the 4096 streams (per-stream seeds hash only the stream index, so they
  are the same streams).
* Deterministic flush, async and pipeline planes.  Under
  ``torch.use_deterministic_algorithms(True)`` the scatter takes its "det"
  variant (each cell summed in an order fixed by slot index) and the
  flush's segment sums the sorted segment-sum kernel; ``onepass`` at B =
  4096 on the ``sparse`` and ``async`` planes, 8 steps, must then give the
  same state and ``sample(k=64)`` bit for bit, as ``twopass``, ``tv`` and
  ``perfect`` must on the first 256 streams.  In the default mode the two
  planes' ingest rates and traced busy shares are recorded (the async
  plane's overlap, measured and not claimed).  The ``pipeline`` plane
  (4 shards, 2 flushes at B = 4096) is held to the sparse plane, and the
  sparse plane to the plain scatter, within the summing tolerances, its
  async sub-planes to its sparse ones bit for bit,
  and a stalled producer's tail must be published by the interval timer.
* Conformance grid.  ``repro_torch.validate.conformance.run_suite``'s
  grid at the nightly operating point (``python -m repro_torch.validate
  --deep``): every sampler, both schemes, p in {0.5, 1, 1.5, 2}, every
  plane (dense, ingest, async, pipeline), n = 96, k = 8, rows 5, width
  31 k, 384 trials against 1,152 oracle trials, and the Table 3 rows
  (n = 10**4, k = 100) at 12 randomizations.  No check may fail, and
  every cell must pass one; the ingest, async and pipeline paths must
  launch the scatter and the estimate kernels, and no plane's thread may
  outlive the grid.  In the deterministic mode the async path's trials
  equal the ingest path's bit for bit.
* Ingest pipeline.  ``PrefetchingFeeder`` at the sparse plane's
  deployment: one canonical ``TurnstileZipfStream(2**20, alpha=1.2,
  delete_fraction=0.25)`` over 4 producer shards, packed into (4096, 4096)
  blocks (B = 4096 streams); fan-in into ``sparse`` and ``async``,
  per-shard into ``pipeline`` (4 shards), each held to the sparse plane's
  direct ingest of the same stream (itself held to the plain scatter's
  table) within the summing bounds and, read
  over the union of both candidate buffers, with the same samples but for
  near ties; fan-in ``async`` equal to fan-in ``sparse`` bit for bit in
  the deterministic mode.  Events/s, pack efficiency, the producers' and
  the pump's wait and the busy share of a traced feed are recorded.

Every estimate of the sparse and dense paths (candidate refresh, sample)
is one launch of the estimate kernel, which takes the median of rows in
registers; the row-read kernel serves ``query_rows`` and tables of more
than 16 rows, and the paths must not launch it.  The summing kernels
(scatter, dense update) have two variants, chosen by shape before the
launch: the shared-memory table (one block per stream chunk) wherever rows
x width fits a block, as at every shape of the three paths, and global
atomics for larger tables.  The paths must run the shared-memory variant;
the script also checks and times the global one at the same shapes (forced
through the wrappers' private ``_variant``).  The transform has a 16-byte
vector variant for aligned tensors and a scalar one, chosen by alignment
(the script reaches the scalar one through views that start one element
in).

Phases (each prints its own lines and its wall time; any failure raises and
the script exits non-zero without the final ``ok`` line):
  1. the card, and the kernels built from ``src/repro_torch/kernels/csrc``
     with ptxas's registers, stack frames and spills, and their shared
     memory and blocks per SM;
  2. each batched kernel against its plain PyTorch version on the card,
     both variants of the scatter at the deployment shape, a hot-key
     stream, and a table too large for shared memory, the scatter at
     p = 0.5, 1.5 and 2 and at the conformance grid's flush shape for each
     of its p and schemes; the estimate at the
     flush shape, on special values and at 17 rows (the row read);
  3. the sparse plane (the kernels) against the dense plane (the plain
     reference), from the same seeds and stream, and a ``torch.profiler``
     trace of the sparse plane's flush stages;
  4. the sparse path's times: kernels (both variants, and a hot-key
     stream), plain versions, library yardsticks, events/s, sample latency,
     peak memory;
  5. the dense segment path against the plain path, the estimate at its
     shape, its times (both variants) and a trace;
  6. the single-stream entry points and ``query_rows_batched`` against
     their plain versions (the transform at p = 0.5, 1, 1.5 and 2, both
     variants, the edge key and n not a multiple of the vector width), and
     times;
  samplers.  ``twopass``, ``tv``, ``onepass``'s exact second pass and
     ``perfect`` against the plain path, their launches (a ``twopass``
     flush 1 scatter + 2 estimates, a ``tv`` flush 2 + 2, a ``tv`` sample
     r + 1 estimates, an ``update_pass2`` call 1 estimate, ``perfect``
     none), traces of a flush and a sample each, times, the recall of the
     exact two-pass sample against the perfect oracle, and the scatter and
     the estimate at the TV cascade's shapes against their bounds;
  determinism.  the det scatter at the flush and the TV cascade shapes
     (three launches identical, each cell within its bound of the plain
     version and of the atomics variant) and the segment sum (equal to the
     CPU's bit for bit), with their times and the NaN fill of
     ``torch.empty`` in the mode; async against sparse bit for bit; the
     overlap; the pipeline; the interval timer;
  validate.  the conformance grid and Table 3, one ``conformance_check``
     line per check and the ``conformance_summary`` line, times by path
     and by sampler, launches by path, live threads; the deterministic
     async cell;
  ingest.  the feeder's fan-in and per-shard runs against direct ingest,
     their rates and waits, a traced feed, the deterministic fan-in;
  7. one ``{"kernels": [...]}`` line, then the ``ok`` line.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
``python3 chip_smoke.py --sass`` instead builds the transform factor alone,
as it was (``-logf`` then ``powf``) and as it is, and prints the static
SASS instruction counts of each (``cuobjdump -sass``); it needs the CUDA
toolkit, not a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

B, ROWS, WIDTH, CANDIDATES, P, K = 4096, 7, 2048, 512, 1.0, 64
INSERTS, STEPS, VOCAB, ALPHA, DELETE_FRACTION = 4096, 8, 1 << 20, 1.2, 0.25
RTOL = 1e-4  # the reference's scale-aware scatter tolerance; atol below
# named ranges of the sparse plane's flush (engine/planes.py) and of
# update_dense (engine/engine.py)
RANGES = ("plane.concat", "plane.h2d", "plane.dispatch", "sparse.scatter",
          "sparse.refresh")
DENSE_RANGES = ("dense.sketch", "dense.refresh")
DEVICE = "cuda"
# the samplers phase: the plain reference runs on the first SUB_B streams
# (per-stream seeds hash only the stream index, so they are the same
# streams); the TV cascade draws TV_K keys (its r = 8 draws)
SUB_B, TV_K = 256, 8
VARIANTS = ("smem", "global")
# kernels' registers, shared memory and blocks per SM, from phase 1
OCCUPANCY: dict = {}
TRANSFORM_PS = (0.5, 1.0, 1.5, 2.0)  # the transform's parity exponents
EDGE_KEY = 17691050  # uniform01 == 1.0 under transform seed 0 (ROADMAP)

# One gemma2_2b decoder layer's gradient leaves, one stream each: the widths
# of src/repro/configs/gemma2_2b.py (d_model 2304, 8 heads, 4 KV heads,
# head_dim 256, d_ff 9216) and the leaves of src/repro/models/transformer.py
# _attn_pd/_mlp_pd/_norms_pd with gemma2's post-norms, in
# jax.tree_util.tree_leaves order (sorted keys).  Cut: 1 layer of 26.
GEMMA_D, GEMMA_H, GEMMA_KV, GEMMA_DH, GEMMA_FF = 2304, 8, 4, 256, 9216
LEAVES = (("ln1", GEMMA_D), ("ln1p", GEMMA_D), ("ln2", GEMMA_D),
          ("ln2p", GEMMA_D), ("wg", GEMMA_D * GEMMA_FF),
          ("wi", GEMMA_D * GEMMA_FF), ("wk", GEMMA_D * GEMMA_KV * GEMMA_DH),
          ("wo", GEMMA_H * GEMMA_DH * GEMMA_D),
          ("wo_mlp", GEMMA_FF * GEMMA_D), ("wq", GEMMA_D * GEMMA_H * GEMMA_DH),
          ("wv", GEMMA_D * GEMMA_KV * GEMMA_DH))
DENSE_STEPS, DENSE_K = 4, 32  # k = gradcomp's k_per_leaf
GRAD_LOG_SCALE = 1.5          # per-coordinate scale exp(1.5 g), g ~ N(0, 1)
# single-stream entry points: benchmarks/sketch_throughput.py's shapes
SINGLE_N = (1_000_000, GEMMA_D * GEMMA_FF)
SINGLE_SEED, SINGLE_KEYS = 3, 512

# Device peaks for the bounds (H100 SXM at 700 W).  HBM3 rate from NVIDIA's
# data sheet.  The integer rate is the fp32 non-tensor rate of the data sheet
# (67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz) scaled to Hopper's 64
# INT32 lanes per SM, counting one operation per lane and clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# 32-bit operations per work item, counted from kernels/csrc/hashing.cuh:
# mix32 = 3 shifts + 3 xors + 2 multiplies = 8; hash_u32 = 2 mix32 + add +
# xor + multiply = 19; row_salt = 3; a bucket = hash + mask (the width is a
# power of two at every timed shape) = 20; a sign = salt xor + hash + and +
# select = 22; an address = 2.  -logf and the power count as one operation
# each (their SASS sequences are longer: ``--sass`` counts them), so these
# are lower bounds.
OPS_PER_ROW = 3 + 20 + 22 + 2
SCATTER_OPS_PER_SLOT = ROWS * OPS_PER_ROW + 24 + 2 + 3   # uniform01, log+pow,
QUERY_OPS_PER_KEY = ROWS * (OPS_PER_ROW + 1)             # mask; query: sign mul


# A median-of-7 selection network: 13 comparators, the median on wire 3
# (N. Devillard, "Fast median search: an ANSI C implementation", 1998).
MEDIAN7_NETWORK = ((0, 5), (0, 3), (1, 6), (2, 4), (0, 1), (3, 5), (2, 6),
                   (2, 3), (3, 6), (4, 5), (1, 4), (1, 3), (3, 4))


def select_ops(rows: int) -> int:
    """The least work the median of 7 reads needs: the min and the max that
    ``MEDIAN7_NETWORK`` computes only where they reach the median, a NaN
    test a row, the add and the multiply."""
    if rows != 7:
        raise ValueError(f"no median network is counted for {rows} rows")
    need, ops = {3}, 0
    for i, j in reversed(MEDIAN7_NETWORK):
        ops += (i in need) + (j in need)
        if i in need or j in need:
            need |= {i, j}
    return ops + rows + 2


ESTIMATE_OPS_PER_KEY = QUERY_OPS_PER_KEY + select_ops(ROWS)
# the dense update computes its key (an add) where the scatter loads and
# tests it, and tests the length alone: the same count per live slot
UPDATE_OPS_PER_SLOT = SCATTER_OPS_PER_SLOT
TRANSFORM_OPS_PER_ELEM = 24 + 2 + 1  # uniform01, log+pow, mul


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float | None:
    """Device time per call of ``fn``: the device activities that a
    ``torch.profiler`` trace of ``iters`` calls records, summed, over
    ``iters`` (None when the profiler sees no device time).  For calls too
    short to keep the card busy, where CUDA events would time the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and "Activity Buffer" not in e.key)
    return busy / 1e3 / iters if busy > 0 else None


def scale_atol(want) -> float:
    """The reference's scale-aware absolute tolerance, 1e-5 * max(1, max|w|)
    over the finite entries (benchmarks/engine_throughput.py)."""
    finite = want[want.isfinite()]
    top = float(finite.abs().max()) if finite.numel() else 0.0
    return 1e-5 * max(1.0, top)


def cell_check(torch, got, want, tol):
    """``got`` against ``want`` cell by cell within the per-cell bound
    ``tol`` (``ref.scatter_tolerance``); a non-finite cell of ``want`` must
    be matched exactly.  Returns (ok, max abs error over the finite cells,
    worst error / bound)."""
    fin = want.isfinite()
    same = (got == want) | (got.isnan() & want.isnan())
    err = torch.where(fin, (got - want).abs(), 0.0)
    # a non-finite cell's bound may be NaN (a NaN old value in its mass)
    ok = bool(same[~fin].all()) and bool(((err <= tol) | ~fin).all())
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float("inf"), 0.0))
    return ok, float(err.max()), float(ratio.max())


def check_sum(torch, what, got, want, tol):
    """A summing kernel's output ``got`` against its plain version ``want``:
    allclose within rtol 1e-4 and the scale-aware atol, and every cell within
    its own rounding bound ``tol``.  Prints a ``[parity]`` line and raises on
    a failure; returns (max abs error, worst error / bound)."""
    torch.cuda.synchronize()
    atol = scale_atol(want)
    close = torch.allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)
    cells, err, ratio = cell_check(torch, got, want, tol)
    nonfinite = int((~want.isfinite()).sum())
    log(f"[parity] {what}: shape {tuple(got.shape)} max_abs_err {err:.3e}; "
        f"allclose atol {atol:.3e} {'ok' if close else 'FAIL'}; per-cell "
        f"bound worst err/bound {ratio:.3e} {'ok' if cells else 'FAIL'}; "
        f"nonfinite {nonfinite}")
    if not (close and cells):
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version")
    return err, ratio


def check_bitwise(torch, what, got, want):
    """A query's output against its plain version, equal under ``==`` with
    NaN equal to NaN (bit for bit but for the sign of a zero).  Prints a
    ``[parity]`` line and raises on a failure."""
    torch.cuda.synchronize()
    ok = got.shape == want.shape and bool(
        ((got == want) | (got.isnan() & want.isnan())).all())
    log(f"[parity] {what}: shape {tuple(got.shape)} equal (==, NaN equal to "
        f"NaN) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version")


def bound(nbytes, ops):
    """The least time in ms for ``nbytes`` moved and ``ops`` 32-bit integer
    operations, and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def special_tables(torch, g, B: int, rows: int, width: int):
    """(B, rows, width) float32 tables, a third of whose cells hold NaN,
    +-inf, +-0, +-3e38 (above FLT_MAX / 2, so a sum of two overflows) or a
    tied +-1, the rest N(0, 1), from the CPU generator ``g``."""
    pool = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0,
                         -0.0, 3e38, -3e38, 1.0, 1.0, -1.0])
    t = torch.randn((B, rows, width), generator=g)
    pick = pool[torch.randint(0, len(pool), t.shape, generator=g)]
    return torch.where(torch.rand(t.shape, generator=g) < 0.33, pick, t)


def check_estimate(torch, what, tables, keys, seeds):
    """``countsketch_estimate_batched`` against the plain median of the
    plain reads (``check_bitwise``); the estimate kernel must launch where
    the rows fit it (``fuses``), else the row read.  Returns the
    estimate."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import ref

    fused = q.fuses(tables.shape[1])
    before = (q.launches, q.estimate_launches)
    got = q.countsketch_estimate_batched(tables, keys, seeds)
    ran = (q.launches - before[0], q.estimate_launches - before[1])
    if ran != ((0, 1) if fused else (1, 0)):
        raise AssertionError(f"estimate {what}: (row read, estimate) "
                             f"launches {ran}")
    check_bitwise(torch, f"estimate {what} "
                  f"[{'estimate kernel' if fused else 'row read + median'}]",
                  got, countsketch.median(
                      ref.countsketch_query_batched_ref(tables, keys, seeds),
                      1))
    return got


def check_no_row_sort(rows, what):
    """The traced window must hold no bitonicSortKVInPlace: PyTorch's sort
    of slices of at most 32 elements, which here was only the median's sort
    over rows."""
    found = [key for _, _, key in rows if "bitonicSort" in key]
    log(f"[profile] {what}: sorts over rows (bitonicSortKVInPlace) in the "
        f"trace: {len(found)}")
    if found:
        raise AssertionError(f"{what}: a sort over rows is still traced")


def gather_index(torch, keys, seeds, width: int, rows: int = ROWS):
    """(B, rows * k) int64 indices into each stream's flat (rows * width)
    table of its (B, k) keys' buckets, row by row: the gather yardstick's
    precomputed input."""
    from repro_torch.core import hashing

    B, k = keys.shape
    out = torch.empty((B, rows * k), dtype=torch.int64, device=keys.device)
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        out[:, r * k:(r + 1) * k] = r * width + hashing.bucket_hash(
            keys, salt, width)
    return out


def table_bytes_read(torch, tables, keys, seeds) -> int:
    """The bytes of the distinct 32-byte sectors of ``tables`` that the
    (B, k) keys' buckets touch: what a query of these keys must read."""
    from repro_torch.core import hashing

    B, rows, width = tables.shape
    hit = torch.zeros(-(-tables.numel() // 8), dtype=torch.bool,
                      device=tables.device)
    base = torch.arange(B, device=tables.device)[:, None] * (rows * width)
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        hit[(base + r * width + hashing.bucket_hash(keys, salt, width))
            // 8] = True
    return int(hit.sum()) * 32


def time_estimate(torch, what, tables, keys, seeds, iters, plain_iters,
                  tag) -> dict:
    """Times of the estimate at one shape: the estimate kernel, the row-read
    kernel alone and with ``countsketch.median`` (the path it replaces),
    the plain version and the gather yardstick (memory half only: the
    row read's gather at precomputed indices), each kernel beside its bound
    from these inputs."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import ref

    B, rows, width = tables.shape
    n = keys.numel()
    t = {
        "estimate": cuda_ms(torch, lambda: q.countsketch_estimate_batched(
            tables, keys, seeds), iters),
        "row_read": cuda_ms(torch, lambda: q.countsketch_query_batched(
            tables, keys, seeds), iters),
        "row_read_median": cuda_ms(torch, lambda: countsketch.median(
            q.countsketch_query_batched(tables, keys, seeds), 1),
            max(2, iters // 4), warmup=1),
        "plain": cuda_ms(torch, lambda: ref.countsketch_estimate_batched_ref(
            tables, keys, seeds), plain_iters, warmup=1)}
    gidx = gather_index(torch, keys, seeds, width, rows)
    flat = tables.reshape(B, rows * width)
    t["library"] = cuda_ms(torch, lambda: torch.gather(flat, 1, gidx), iters)
    del gidx
    read = table_bytes_read(torch, tables, keys, seeds)
    row_ops = n * rows * (OPS_PER_ROW + 1)
    t["bound"], t["bound_by"] = bound(n * 8 + read,
                                      row_ops + n * select_ops(rows))
    t["row_bound"], t["row_bound_by"] = bound(n * 4 + read + n * rows * 4,
                                              row_ops)
    log(f"[time] estimate {what} (B={B}, k={keys.shape[1]}): estimate "
        f"kernel {t['estimate']:.4f} ms, bound {t['bound']:.4f} ms by "
        f"{t['bound_by']}, {100 * t['bound'] / t['estimate']:.1f} % of bound; "
        f"row read + countsketch.median {t['row_read_median']:.4f} ms (row "
        f"read alone {t['row_read']:.4f} ms, bound {t['row_bound']:.4f} ms by "
        f"{t['row_bound_by']}); plain {t['plain']:.4f} ms; gather yardstick "
        f"(memory half only) {t['library']:.4f} ms; table sectors read "
        f"{read / 1e6:.1f} MB {tag}")
    return t


def row_index(torch, keys, seeds, width: int, rows: int = ROWS):
    """Flat (stream, row, bucket) indices and signs of (B, n) keys, row by
    row: (B, rows * n) int64 and float32, for the library yardsticks."""
    from repro_torch.core import hashing

    base = torch.arange(keys.shape[0], device=keys.device)[:, None] \
        * (rows * width)
    idx, sign = [], []
    for r in range(rows):
        salt = hashing.row_salt(seeds[:, None], r)
        idx.append(base + r * width + hashing.bucket_hash(keys, salt, width))
        sign.append(hashing.sign_hash(keys, salt))
    return torch.cat(idx, 1), torch.cat(sign, 1)


def report_occupancy(tag):
    """Each kernel's registers, static and dynamic shared memory and
    resident blocks per SM at its launch shape (the CUDA occupancy
    calculator, through each source's ``worp_<name>_info``)."""
    from repro_torch.kernels import build, tiling

    table = ROWS * WIDTH * 4
    for name, variant, label, threads, smem in (
            ("countsketch_scatter", 1, "smem", tiling.TABLE_THREADS, table),
            ("countsketch_scatter", 0, "global", tiling.THREADS_PER_BLOCK, 0),
            ("countsketch_scatter", 2, "det", 32 * min(ROWS,
                                                       tiling.DET_MAX_WARPS),
             tiling.det_smem_bytes(ROWS, WIDTH)),
            ("countsketch_update", 1, "smem", tiling.TABLE_THREADS, table),
            ("countsketch_update", 0, "global", tiling.THREADS_PER_BLOCK, 0),
            ("countsketch_query", 0, "", tiling.THREADS_PER_BLOCK, 0),
            ("countsketch_query", 1, "estimate", tiling.THREADS_PER_BLOCK,
             0),
            ("ppswor_transform", 0, "float32", tiling.THREADS_PER_BLOCK, 0),
            ("ppswor_transform", 1, "bfloat16", tiling.THREADS_PER_BLOCK,
             0),
            ("ppswor_transform", 2, "float32 vector",
             tiling.THREADS_PER_BLOCK, 0),
            ("ppswor_transform", 3, "bfloat16 vector",
             tiling.THREADS_PER_BLOCK, 0),
            ("segment_sum", 0, "", tiling.THREADS_PER_BLOCK, 0)):
        info = build.kernel_info(name, variant, threads, smem)
        info.update(threads=threads, dynamic_smem=smem)
        OCCUPANCY[(name, label)] = info
        log(f"[occupancy] {name}{' ' + label if label else ''}: "
            f"{info['registers']} registers a thread, {threads} threads, "
            f"static smem {info['static_smem']} B, dynamic smem {smem} B "
            f"(limit {info['max_dynamic_smem']} B), {info['blocks_per_sm']} "
            f"blocks per SM {tag}")


# ``--sass``: the transform factor alone, as it was (-logf, then powf
# whatever the exponent) and as csrc/hashing.cuh has it now, one element a
# thread; {E} is the exponent, run-time or a float32 constant
FACTOR_PROBE = """#include "hashing.cuh"
extern "C" __global__ void old_factor(const unsigned* keys, float* out,
                                      unsigned tseed, float e) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = powf(-logf(worp::uniform01(keys[i], tseed)), {E});
}
extern "C" __global__ void new_factor(const unsigned* keys, float* out,
                                      unsigned tseed, float e) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = worp::transform_factor(keys[i], tseed, worp::kPpswor, {E});
}
"""
SASS_EXPONENTS = {"run-time": "e", "p=1": "-1.0f", "p=1.5": "(-1.0f / 1.5f)"}


def factor_sass() -> int:
    """Build the factor probe for each exponent and print each kernel's
    static SASS instructions (no NOP) and its MUFU (special-function)
    instructions, from ``cuobjdump -sass``."""
    import re

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    nvcc = build.nvcc()
    out_dir = build.BUILD_DIR / "factor_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, e in SASS_EXPONENTS.items():
        cu = out_dir / f"factor_probe_{label.replace('.', '_')}.cu"
        cu.write_text(FACTOR_PROBE.replace("{E}", e))
        cubin = cu.with_suffix(".cubin")
        subprocess.run([nvcc, *build.NVCC_FLAGS[:4], "-I", str(build.CSRC),
                        "-cubin", "-o", str(cubin), str(cu)], check=True,
                       timeout=300)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for fn in ("old_factor", "new_factor"):
            body = sass.split(f"Function : {fn}")[1].split("Function :")[0]
            ops = []
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", body):
                words = m.group(1).split()
                op = words[1] if words[0].startswith("@") else words[0]
                ops += [] if op.startswith("NOP") else [op]
            mufu = sum(op.startswith("MUFU") for op in ops)
            log(f"[sass] {fn}, exponent {label}: {len(ops)} instructions, "
                f"{mufu} MUFU")
    return 0


def plan_of(B, n, lengths, rows=ROWS, width=WIDTH, variant=None):
    """The shared-memory (or forced ``variant``'s) plan the wrappers launch
    for these shapes."""
    from repro_torch.kernels import tiling

    p = tiling.table_plan(B, n, tiling.host_lengths(lengths, B, n), rows,
                          width, tiling.sm_count(DEVICE), variant)
    return {"blocks": p.blocks, "threads": p.threads, "chunk": p.chunk,
            "one_per_stream": p.one_per_stream, "smem_bytes": p.smem_bytes}


def variants_entry(source, launches, errs, ms, plans, hot_ms=None):
    """The kernels line's per-variant record of a summing kernel: its
    launches on the main path, max error and worst error / bound against
    the plain version, time, plan and occupancy."""
    out = {}
    for v in VARIANTS:
        out[v] = {"launches": launches[v], "max_abs_err": errs[v][0],
                  "worst_err_over_bound": errs[v][1], "ms": ms[v],
                  "plan": plans.get(v, "one thread per slot"),
                  "occupancy": OCCUPANCY.get((source, v))}
        if hot_ms is not None:
            out[v]["hot_key_ms"] = hot_ms[v]
    return out


def launched(module, before):
    """The one variant of ``module``'s kernel launched since ``before`` (a
    copy of its ``variant_launches``); raises unless exactly one launch."""
    ran = {v: module.variant_launches[v] - before[v] for v in VARIANTS}
    if sorted(ran.values()) != [0, 1]:
        raise AssertionError(f"expected one launch, got {ran}")
    return max(ran, key=ran.get)


def make_stream(seed: int):
    """Per-step (B, n) keys/values of the deployment's B shards (numpy)."""
    from repro_torch.data.pipeline import TurnstileZipfStream
    import numpy as np

    stream = TurnstileZipfStream(vocab_size=VOCAB, alpha=ALPHA, seed=seed,
                                 delete_fraction=DELETE_FRACTION)
    steps = []
    for t in range(STEPS):
        batches = [stream.sparse_batch_at(t, b, INSERTS) for b in range(B)]
        steps.append((np.stack([k for k, _ in batches]),
                      np.stack([v for _, v in batches])))
    return stream, steps


def make_gradients(seed: int):
    """Gradient-like signed values of the layer's leaves (numpy): a fixed
    per-coordinate scale exp(1.5 g) per leaf, times fresh N(0, 1) noise each
    step.  Returns the leaf sizes, the per-step (L, n_max) float32 values
    (zero past each leaf's length) and their float64 sum over the steps."""
    import numpy as np

    sizes = [n for _, n in LEAVES]
    scales = [np.exp(GRAD_LOG_SCALE * np.random.default_rng(
        [seed, 0, b]).standard_normal(n, dtype=np.float32))
        for b, n in enumerate(sizes)]
    steps, total = [], np.zeros((len(sizes), max(sizes)))
    for t in range(DENSE_STEPS):
        vals = np.zeros((len(sizes), max(sizes)), np.float32)
        for b, n in enumerate(sizes):
            noise = np.random.default_rng([seed, 1 + t, b]).standard_normal(
                n, dtype=np.float32)
            np.multiply(scales[b], noise, out=vals[b, :n])
        total += vals
        steps.append(vals)
    return sizes, steps, total


def phase_parity(torch, seeds, tseeds, keys, vals, tag):
    """Each batched kernel against its plain version on the card: the
    scatter and the dense update within rtol 1e-4 / scale-aware atol and
    within each cell's rounding bound, the query bit for bit.  The scatter
    at the deployment shape in both variants, the shared-memory one by
    shape; a hot-key stream; rows 7 x width 16384 by shape global; the
    conformance grid's flushes, (trials, n / chunks) keys of its Zipf
    stream into rows 5 x width 31 k under its trial seeds, at each of its
    p and schemes."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ref
    from repro_torch.validate import conformance, empirics

    dev = keys.device
    results = {}
    ratios = []

    def check_scatter(name, k, v, rows, width, sd, ts, variants=(None,),
                      expect="smem", **kw):
        want = ref.countsketch_scatter_batched_ref(k, v, rows, width, sd,
                                                   transform_seeds=ts, **kw)
        tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
            k, v, rows, width, sd, transform_seeds=ts, **kw))
        out = {}
        for variant in variants:
            before = dict(s.variant_launches)
            got = s.countsketch_scatter_batched(k, v, rows, width, sd,
                                                transform_seeds=ts,
                                                _variant=variant, **kw)
            ran = launched(s, before)
            if ran != (variant or expect):
                raise AssertionError(f"scatter {name}: launched {ran}")
            err, ratio = check_sum(torch, f"scatter {name} [{ran}]", got,
                                   want, tol)
            ratios.append(ratio)
            out[ran] = (err, ratio)
        del want, tol
        return got, out

    # deployment shape: one flush of a full step, fused ppswor p=1; the
    # global variant first, so ``table`` is the shared-memory kernel's
    table, results["scatter"] = check_scatter(
        "deployment", keys, vals, ROWS, WIDTH, seeds, tseeds,
        variants=("global", None), p=P)
    hot = torch.zeros_like(keys)  # one key, n times, in every stream
    _, results["scatter_hot"] = check_scatter(
        "hot key (key 0 x n)", hot, vals, ROWS, WIDTH, seeds, tseeds,
        variants=(None, "global"), p=P)
    del hot

    g = torch.Generator(device="cpu").manual_seed(1)

    def rand_stream(b, n, hi=50_000):
        k = torch.randint(0, hi, (b, n), generator=g, dtype=torch.int32)
        v = torch.randn((b, n), generator=g)
        sd = torch.randint(0, 2**32, (b,), generator=g, dtype=torch.int64)
        ts = torch.randint(0, 2**32, (b,), generator=g, dtype=torch.int64)
        return k.to(dev), v.to(dev), sd.to(dev), ts.to(dev)

    k, v, sd, ts = rand_stream(1, 1)
    check_scatter("B=1,n=1", k, v, ROWS, WIDTH, sd, ts, p=P)
    k, v, sd, ts = rand_stream(8, 1000)
    check_scatter("W=1000", k, v, 5, 1000, sd, ts, p=P)
    check_scatter("rows 7 x W=16384 (too large for shared memory)", k, v,
                  ROWS, 16384, sd, ts, expect="global", p=P)
    kp = k.clone()
    kp[3] = -1
    got, _ = check_scatter("all-padding stream 3", kp, v, ROWS, WIDTH,
                           sd, ts, p=P)
    if got[3].any():
        raise AssertionError("all-padding stream is not exactly zero")
    lens = torch.full((8,), 1000, dtype=torch.int64, device=dev)
    lens[2], lens[5] = 0, 377
    got, _ = check_scatter("zero-length stream 2", k, v, ROWS, WIDTH,
                           sd, ts, p=P, lengths=lens)
    if got[2].any():
        raise AssertionError("zero-length stream is not exactly zero")
    check_scatter("priority", k, v, ROWS, WIDTH, sd, ts, p=P,
                  scheme="priority")
    check_scatter("p=0.5", k, v, ROWS, WIDTH, sd, ts, p=0.5)
    check_scatter("p=2", k, v, ROWS, WIDTH, sd, ts, p=2.0)
    check_scatter("p=1.5", k, v, ROWS, WIDTH, sd, ts, p=1.5)
    check_scatter("p=None", k, v, ROWS, WIDTH, sd, ts, p=None)
    cfg = conformance.ConformanceConfig(trials=VALIDATE_TRIALS)
    step, width = -(-cfg.n // cfg.chunks), 31 * cfg.k
    freqs = empirics.zipf_freqs(cfg.n, cfg.alpha, seed=cfg.seed & 0xFF)
    gk = torch.arange(step, dtype=torch.int32, device=dev).repeat(
        cfg.trials, 1)
    gv = torch.tensor(freqs[:step], device=dev).repeat(cfg.trials, 1)
    gsd, gts = empirics.derive_trial_seeds(cfg.trials, cfg.seed, device=dev)
    for scheme in conformance.SCHEMES:
        for gp in conformance.PS:
            check_scatter(f"grid {scheme} p={gp:g} ({cfg.trials}, {step}) "
                          f"rows {cfg.rows} x W={width}", gk, gv, cfg.rows,
                          width, gsd, gts, p=gp, scheme=scheme)
    results["scatter_ratio"] = max(ratios)
    results["scatter_err"] = {v: results["scatter"][v][0] for v in VARIANTS}

    def check_query(name, tables, qk, sd):
        check_bitwise(torch, f"query {name}",
                      q.countsketch_query_batched(tables, qk, sd),
                      ref.countsketch_query_batched_ref(tables, qk, sd))

    qkeys = torch.cat([torch.full((B, CANDIDATES), -1, dtype=torch.int32,
                                  device=dev), keys], 1).contiguous()
    check_query("deployment (candidates + batch)", table, qkeys, seeds)
    tables = torch.randn((8, 5, 1000), generator=g).to(dev)
    check_query("W=1000,k=1", tables, k[:, :1].contiguous(), sd)
    check_query("B=1", tables[:1].contiguous(), k[:1].contiguous(), sd[:1])

    # the estimate kernel: the flush shape, special values at every row
    # count it serves and at 17 rows (the row read and the plain median)
    check_estimate(torch, "flush shape (candidates + batch)", table, qkeys,
                   seeds)
    for rows in (1, 2, 3, 4, 5, 6, 7, 8, 16, 17):
        check_estimate(torch, f"rows={rows} W=1000 k=1000, NaN/+-inf/+-0/"
                       f"+-3e38/ties", special_tables(torch, g, 8, rows,
                                                      1000).to(dev), k, sd)

    # the dense update kernel at its edge shapes (its deployment shape is
    # checked in the dense phase)
    uratios = []

    def check_update(name, vv, rows, width, sd, ts, **kw):
        got = u.countsketch_update_batched(vv, rows, width, sd,
                                           transform_seeds=ts, **kw)
        want = ref.countsketch_update_batched_ref(vv, rows, width, sd,
                                                  transform_seeds=ts, **kw)
        tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
            vv, rows, width, sd, transform_seeds=ts, **kw))
        uratios.append(check_sum(torch, f"update {name}", got, want,
                                 tol)[1])
        return got

    _, v, sd, ts = rand_stream(1, 1)
    check_update("B=1,n=1", v, ROWS, WIDTH, sd, ts, p=P)
    _, v, sd, ts = rand_stream(8, 1000)
    check_update("W=1000", v, 5, 1000, sd, ts, p=P)
    got = check_update("zero-length stream 2", v, ROWS, WIDTH, sd, ts, p=P,
                       lengths=lens)
    if got[2].any():
        raise AssertionError("zero-length stream is not exactly zero")
    past = torch.tensor([1000, 1001, 5000, 2**31 - 1, 0, 1, 999, 4096],
                        device=dev)
    check_update("lengths > n", v, ROWS, WIDTH, sd, ts, p=P, lengths=past)
    # keys wrap past 2**31 and 2**32; stream 1 sketches key 0xFFFFFFFF
    wrap = torch.tensor([2**31 - 500, 2**32 - 5, 2**32 - 1, 0, 7, 2**31,
                         2**32 - 1000, 123], device=dev)
    check_update("base keys near 2**31 and 2**32-5", v, ROWS, WIDTH, sd, ts,
                 p=P, base_keys=wrap)
    check_update("priority", v, ROWS, WIDTH, sd, ts, p=P, scheme="priority")
    check_update("p=0.5", v, ROWS, WIDTH, sd, ts, p=0.5)
    check_update("p=2", v, ROWS, WIDTH, sd, ts, p=2.0)
    check_update("p=None", v, ROWS, WIDTH, sd, ts, p=None)
    # several chunks a stream, ragged lengths, keys wrapping through
    # 0xFFFFFFFF inside a chunk, an empty stream
    _, v, sd, ts = rand_stream(4, 200_000)
    check_update("chunked, ragged, wrapping", v, ROWS, WIDTH, sd, ts, p=P,
                 lengths=torch.tensor([200_000, 77_123, 0, 150_001],
                                      device=dev),
                 base_keys=torch.tensor([0, 2**31 - 500, 5, 2**32 - 100_000],
                                        device=dev))
    results["update_edge_ratio"] = max(uratios)
    log(f"[parity] all batched kernels agree with their plain versions {tag}")
    return results, table, qkeys


def run_engine(torch, plane, steps, flush_policy, sample=True):
    from repro_torch.engine import EngineConfig, SketchEngine

    eng = SketchEngine(EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                                    candidates=CANDIDATES, p=P),
                       plane=plane, flush=flush_policy, device=DEVICE)
    flushes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for keys, vals in steps:
        eng.ingest(keys, vals)
        flushes += eng.pending == 0
    eng.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if not sample:
        return eng, None, flushes, ingest_s, None
    t0 = time.perf_counter()
    samp = eng.sample(K)
    torch.cuda.synchronize()
    return eng, samp, flushes, ingest_s, time.perf_counter() - t0


def compare_tables(torch, what, got, want, tol):
    """The kernel path's tables against the plain path's, within both
    bounds; returns the streams whose plain tables hold non-finite cells
    (the reference's uniform01 == 1.0 edge)."""
    atol = scale_atol(want)
    close = torch.allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)
    cells, t_err, t_ratio = cell_check(torch, got, want, tol)
    bad_streams = (~want.isfinite()).flatten(1).any(1)
    log(f"[main] {what} tables: max_abs_err {t_err:.3e}; allclose "
        f"rtol {RTOL} atol {atol:.3e}: {'ok' if close else 'FAIL'}; "
        f"per-cell bound worst err/bound {t_ratio:.3e}: "
        f"{'ok' if cells else 'FAIL'}; streams with non-finite cells (the "
        f"reference's uniform01 == 1.0 edge): {int(bad_streams.sum())}")
    if not (close and cells):
        raise AssertionError(f"{what} tables disagree")
    return bad_streams


def compare_samples(torch, what, samp, dst, tol, seeds, k, p, bad_streams,
                    excused=None, excuse=""):
    """The kernel path's sample keys against the plain state read through
    the plain estimate (``worp.onepass_sample``).  A stream's key set may
    differ only where the k-th and (k+1)-st |estimate| differ by less than
    the sum of their error bounds (a key's bound is the largest bound of the
    cells its rows read), or where the plain table is not finite, or where
    ``excused`` (a (B,) mask, for the reason ``excuse``) holds."""
    from repro_torch.core import countsketch, worp
    from repro_torch.kernels import ref

    dsamp = worp.onepass_sample(dst, k, p)
    cand = dst.cand_keys
    mag = torch.where(cand == -1, float("-inf"),
                      countsketch.estimate(dst.sketch, cand).abs())
    top_mag, top_i = worp.top_k(mag, k + 1)
    key_err = ref.countsketch_query_batched_ref(tol, cand, seeds).abs()
    pair_err = torch.gather(key_err.amax(1), 1, top_i[:, k - 1:k + 1])
    near_tie = (top_mag[:, k - 1] - top_mag[:, k]) <= pair_err.sum(1)
    same = (torch.sort(samp.keys, 1).values
            == torch.sort(dsamp.keys, 1).values).all(1)
    if excused is None:
        excused = torch.zeros_like(same)
    mismatch = int((~same & ~(near_tie | bad_streams | excused)).sum())
    n = samp.keys.shape[0]
    log(f"[main] {what} sample key sets: {int(same.sum())}/{n} identical, "
        f"{int(near_tie.sum())} near-tie streams, {int((~same).sum())} "
        f"differ"
        + (f", {int((~same & excused & ~near_tie).sum())} of them outside "
           f"near ties excused ({excuse})" if excuse else "")
        + f", {mismatch} differ outside near ties / non-finite streams")
    if mismatch:
        raise AssertionError(f"{what} sample key sets differ from the plain "
                             f"path's")
    if not bool(samp.freqs[~bad_streams].isfinite().all()):
        raise AssertionError(f"{what}: non-finite sample frequencies")


def trace_report(prof, ranges, wall_ms, what, tag, top: int = 12):
    """Print the named ranges (host time, and the device time of the
    PyTorch ops each launched), device time by kernel, and the device's busy
    share over ``wall_ms`` of a ``torch.profiler`` trace.  Returns the
    device items, (ms, count, name), largest first."""
    from torch.autograd import DeviceType

    # device-side activities only (kernels, copies, memsets): the host ops
    # that launched them carry the same device time a second time, and the
    # device-side copies of the named ranges span their kernels
    rows, stages = [], {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if e.key in ranges:
            if e.device_type == DeviceType.CPU:
                incl = getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
                stages[e.key] = (e.count, e.cpu_time_total / 1e3, incl / 1e3)
        elif dev_us > 0 and e.device_type != DeviceType.CPU:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    for name in ranges:
        if name not in stages:
            log(f"[profile] stage {name}: not in the trace")
            continue
        n, host, dev = stages[name]
        log(f"[profile] stage {name} x{n}: host {host / n:.3f} ms, device "
            f"{dev / n:.3f} ms per call, PyTorch's ops only (the kernels "
            f"launched through ctypes are listed by name) (traced run) {tag}")
    # the profiler's own buffer requests are not the program's work
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    if not rows:
        log(f"[profile] the profiler saw no device time: not measured {tag}")
        return rows
    log(f"[profile] {what}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f} %), idle "
        f"{100 * (1 - busy / wall_ms):.1f} % (traced run) {tag}")
    for ms, count, key in rows[:top]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return rows


def profile_window(torch, steps, tag):
    """torch.profiler over two flushes and one sample of a fresh sparse
    engine."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import EngineConfig, SketchEngine

    eng = SketchEngine(EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                                    candidates=CANDIDATES, p=P),
                       flush_elems=4096, device=DEVICE)
    eng.ingest(*steps[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest(*steps[1])
        eng.ingest(*steps[2])
        eng.sample(K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check_no_row_sort(trace_report(prof, RANGES, wall_ms,
                                   "2 flushes + sample", tag),
                      "sparse plane, 2 flushes + sample")


def phase_sparse(torch, args, seeds, tseeds, tag):
    """Phases 2-4: batched kernel parity, the sparse plane against the dense
    plane, and the sparse path's times.  Returns the kernels-line entries of
    the scatter and the batched query."""
    import numpy as np

    from repro_torch.core import transforms
    from repro_torch.engine import FlushPolicy
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    stream, steps = make_stream(args.seed)
    events = sum(k.size for k, _ in steps)
    log(f"[stream] generated {STEPS} steps x {B} streams = {events} signed "
        f"events on the host in {time.perf_counter() - t0:.2f} s (kept out "
        f"of the ingest rate)")

    # -- phase 2: kernel parity -----------------------------------------
    t_phase = time.perf_counter()
    keys1 = torch.from_numpy(steps[1][0]).to(dev)
    vals1 = torch.from_numpy(steps[1][1]).to(dev)
    errs, table, qkeys = phase_parity(torch, seeds, tseeds, keys1, vals1, tag)
    log(f"[phase] 2 kernel parity: {time.perf_counter() - t_phase:.2f} s "
        f"wall")

    # -- phase 3: the sparse plane (kernels) and the dense plane (plain) --
    t_phase = time.perf_counter()
    policy = FlushPolicy(max_elems=4096)
    s.launches = q.launches = q.estimate_launches = 0
    s.variant_launches.update(dict.fromkeys(VARIANTS, 0))
    torch.cuda.reset_peak_memory_stats()
    eng, samp, flushes, ingest_s, sample_s = run_engine(torch, "sparse",
                                                        steps, policy)
    scatter_launches, estimate_launches = s.launches, q.estimate_launches
    scatter_variants = dict(s.variant_launches)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"[main] sparse plane: {flushes} flushes, scatter launches "
        f"{scatter_launches} ({scatter_variants}), estimate launches "
        f"{estimate_launches}, row-read launches {q.launches}")
    if scatter_launches != flushes or flushes == 0:
        raise AssertionError("scatter launches do not match the flushes")
    if scatter_variants["smem"] != flushes:
        raise AssertionError("the sparse plane did not run the shared-memory "
                             "scatter")
    if estimate_launches < flushes + 1:
        raise AssertionError("estimate launches < flushes + 1")
    if q.launches:
        raise AssertionError("the sparse path launched the row-read kernel")
    st = eng.state
    if tuple(samp.keys.shape) != (B, K) or samp.keys.dtype != torch.int32:
        raise AssertionError(f"sample keys shape {tuple(samp.keys.shape)}")

    dense, _, dflushes, dense_s, _ = run_engine(torch, "dense", steps,
                                                policy, sample=False)
    dst = dense.state
    # each cell's rounding bound over all steps: any summation order of its
    # terms, the sparse plane's per-flush deltas included
    cnt = torch.zeros_like(dst.sketch.table)
    mass = torch.zeros_like(dst.sketch.table)
    for keys, vals in steps:
        c, m = ref.countsketch_scatter_mass_ref(
            torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
            ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
        cnt += c
        mass += m
    tol = ref.scatter_tolerance(cnt, mass)
    del cnt, mass, c, m
    bad_streams = compare_tables(torch, "sparse vs dense plane",
                                 st.sketch.table, dst.sketch.table, tol)
    compare_samples(torch, "sparse vs dense plane", samp, dst, tol, seeds, K,
                    P, bad_streams)
    del tol

    recalls = []
    for b in range(8):
        f = stream.aggregate_freqs(b, STEPS, INSERTS)
        nz = np.nonzero(f)[0]
        tstar = transforms.transform_frequencies(
            torch.from_numpy(nz.astype(np.int32)),
            torch.from_numpy(f[nz].astype(np.float32)), P,
            int(tseeds[b]))
        exact = set(nz[torch.argsort(tstar.abs(), descending=True,
                                     stable=True)[:K].numpy()].tolist())
        recalls.append(len(exact & set(samp.keys[b].tolist())) / K)
    log(f"[main] recall of the exact bottom-{K} on streams 0-7: "
        + " ".join(f"{r:.3f}" for r in recalls))
    if min(recalls) < 0.5:
        raise AssertionError("sample recall below 0.5")
    del dense, dst
    profile_window(torch, steps, tag)
    log(f"[phase] 3 sparse plane: {time.perf_counter() - t_phase:.2f} s wall")

    # -- phase 4: times --------------------------------------------------
    t_phase = time.perf_counter()
    log(f"[time] sparse plane: {events} events ingested in {ingest_s:.4f} s "
        f"= {events / ingest_s:.4e} events/s; sample(k={K}) {sample_s * 1e3:.3f}"
        f" ms (first call); dense plane {dense_s:.4f} s = "
        f"{events / dense_s:.4e} events/s; peak memory {peak_mb:.1f} MB "
        f"{tag}")
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample(K)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[time] sample(k={K}) latency, 5 calls: "
        + " ".join(f"{x:.3f}" for x in sample_ms) + f" ms {tag}")
    del eng, st, samp

    n1 = keys1.shape[1]
    hot = torch.zeros_like(keys1)
    s_var, s_hot = {}, {}
    for variant in VARIANTS:
        s_var[variant] = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
            keys1, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds,
            _variant=variant), 20)
        s_hot[variant] = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
            hot, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds,
            _variant=variant), 20)
    del hot
    scatter_plain = lambda: ref.countsketch_scatter_batched_ref(  # noqa: E731
        keys1, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
    # library yardstick, memory half only: precomputed flat indices and
    # signed transformed values into a zeroed table with index_add_
    tv = transforms.transform_values(keys1, vals1, P, tseeds[:, None])
    idx, sign = row_index(torch, keys1, seeds, WIDTH)
    idx = idx.reshape(-1)
    sv = (sign * tv.repeat(1, ROWS)).reshape(-1)
    flat = torch.zeros(B * ROWS * WIDTH, device=dev)
    scatter_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    s_ms = s_var["smem"]
    s_plain = cuda_ms(torch, scatter_plain, 3, warmup=1)
    s_lib = cuda_ms(torch, scatter_lib, 20)
    del idx, sign, sv, flat, tv

    est_t = time_estimate(torch, "flush shape", table, qkeys, seeds, 20, 3,
                          tag)

    # bounds from this run's inputs: each input read once, each output
    # written once; integer work for the slots/keys this data makes live
    live = int((keys1 != -1).sum())
    s_bytes = keys1.numel() * 8 + B * ROWS * WIDTH * 4
    s_ops = live * SCATTER_OPS_PER_SLOT
    s_bound, s_by = bound(s_bytes, s_ops)
    log(f"[time] scatter (B={B}, n={n1}): kernel {s_ms:.4f} ms (shared "
        f"memory; global atomics {s_var['global']:.4f} ms), plain "
        f"{s_plain:.4f} ms, index_add_ yardstick (memory half only) "
        f"{s_lib:.4f} ms, bound {s_bound:.4f} ms by {s_by} "
        f"({s_bytes / 1e6:.1f} MB, {s_ops / 1e9:.2f} G int ops), "
        f"{100 * s_bound / s_ms:.1f} % of bound {tag}")
    log(f"[time] scatter hot key (key 0 x {n1} in each of {B} streams): "
        f"shared memory {s_hot['smem']:.4f} ms, global atomics "
        f"{s_hot['global']:.4f} ms; the hot key costs "
        f"{s_hot['smem'] - s_ms:+.4f} ms on the shared-memory kernel {tag}")
    log(f"[phase] 4 sparse times: {time.perf_counter() - t_phase:.2f} s wall")
    plan = plan_of(B, n1, None)
    return (stream, steps), [
        {"name": "countsketch_scatter_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_scatter.cu",
         "replaces": "src/repro/kernels/countsketch_scatter.py:112",
         "launches": scatter_launches,
         "max_abs_err": errs["scatter_err"]["smem"],
         "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                   f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
         "worst_err_over_bound": errs["scatter_ratio"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib, "variant": "smem",
         "variants": variants_entry(
             "countsketch_scatter", scatter_variants, errs["scatter"],
             s_var, {"smem": plan}, hot_ms=s_hot)},
        {"name": "countsketch_estimate_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:150",
         "launches": estimate_launches,  # the dense path's are added
         "max_abs_err": 0.0,
         "parity": "equal under == (NaN equal to NaN) to countsketch.median "
                   "of the plain reads",
         "ms": est_t["estimate"], "plain_ms": est_t["plain"],
         "bound_ms": est_t["bound"], "bound_by": est_t["bound_by"],
         "library_ms": est_t["library"],
         "row_read_median_ms": est_t["row_read_median"],
         "row_read_ms": est_t["row_read"],
         "occupancy": OCCUPANCY.get(("countsketch_query", "estimate"))},
    ], errs


def profile_dense(torch, cfg, values, sizes, tag):
    """torch.profiler over one update_dense of a fresh engine: the split of
    its ranges ``dense.sketch`` and ``dense.refresh``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import SketchEngine

    eng = SketchEngine(cfg, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.update_dense(values, lengths=sizes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check_no_row_sort(trace_report(prof, DENSE_RANGES, wall_ms,
                                   "1 update_dense", tag, top=8),
                      "dense segments, 1 update_dense")


def phase_dense(torch, args, tag):
    """Phase 5: SketchEngine.update_dense on one gemma2_2b layer's gradient
    streams (kernels) against the plain path, its times and a trace.
    Returns the kernels-line entry of the dense update and the wg leaf's
    first-step values (for the single-stream phase)."""
    import functools

    import numpy as np

    from repro_torch.core import transforms, worp
    from repro_torch.engine import (EngineConfig, SketchEngine,
                                    derive_stream_seeds, onepass_init_batched)
    from repro_torch.engine.engine import _map, _map2
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    sizes, steps, total = make_gradients(args.seed)
    L, n_max, live = len(sizes), max(sizes), sum(sizes)
    log(f"[dense] one gemma2_2b layer: {L} gradient streams ("
        + ", ".join(f"{name} {n}" for name, n in LEAVES) + f"), n_max "
        f"{n_max}, {live} live elements a step; {DENSE_STEPS} steps "
        f"generated on the host in {time.perf_counter() - t_phase:.2f} s "
        f"(kept out of the update rate)")
    cfg = EngineConfig(num_streams=L)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)
    lengths = torch.tensor(sizes, device=dev)

    # the kernel against its plain version at the deployment shape, both
    # variants, the shared-memory one by shape
    v0 = torch.from_numpy(steps[0]).to(dev)
    kw = dict(p=cfg.p, transform_seeds=tseeds, lengths=lengths)
    want = ref.countsketch_update_batched_ref(v0, cfg.rows, cfg.width, seeds,
                                              **kw)
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        v0, cfg.rows, cfg.width, seeds, **kw))
    u_errs = {}
    for variant in (None, "global"):
        before = dict(u.variant_launches)
        got = u.countsketch_update_batched(v0, cfg.rows, cfg.width, seeds,
                                           _variant=variant, **kw)
        ran = launched(u, before)
        if ran != (variant or "smem"):
            raise AssertionError(f"update gemma2_2b layer: launched {ran}")
        u_errs[ran] = check_sum(torch, f"update gemma2_2b layer (step 0) "
                                f"[{ran}]", got, want, tol)
        del got
    del want, tol
    u_err, u_ratio = u_errs["smem"]

    # peak of one update_dense, reckoned from its shapes: the (L, n_max)
    # values and int32 keys, and the (L, n_max + C) arrays live together in
    # the candidate refresh's last sort (worp._dedup_topc's top_k): the
    # query keys, the estimate and 10 more of 4 bytes, 3 of 8 (the argsort
    # order, the segment ids, the sort's indices) and 2 boolean masks.  The
    # estimate kernel writes one float a key, so the (L, rows, n_max + C)
    # reads and their sort (16 bytes a read) are gone.
    nq = L * (n_max + cfg.candidates)
    reckoned = L * n_max * 4 * 2 + nq * (12 * 4 + 3 * 8 + 2)
    log(f"[dense] reckoned peak of one update_dense: {reckoned / 1e9:.2f} GB "
        f"(values and keys {L * n_max * 8 / 1e9:.2f} GB, the refresh's "
        f"arrays {nq * 74 / 1e9:.2f} GB; the sorts' own buffers are not "
        f"counted)")

    # -- the main path: update_dense x DENSE_STEPS, then sample ----------
    del v0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    u.launches = q.launches = q.estimate_launches = 0
    u.variant_launches.update(dict.fromkeys(VARIANTS, 0))
    eng = SketchEngine(cfg, device=DEVICE)
    update_s = []
    for vals in steps:
        dv = torch.from_numpy(vals).to(dev)  # the gradients live on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.update_dense(dv, lengths=sizes)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        del dv
    t0 = time.perf_counter()
    samp = eng.sample(DENSE_K)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    update_launches, estimate_launches = u.launches, q.estimate_launches
    update_variants = dict(u.variant_launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] dense segments: {DENSE_STEPS} update_dense calls, update "
        f"launches {update_launches} ({update_variants}), estimate launches "
        f"{estimate_launches}, row-read launches {q.launches}")
    if update_launches != DENSE_STEPS:
        raise AssertionError("update launches do not match update_dense calls")
    if update_variants["smem"] != DENSE_STEPS:
        raise AssertionError("update_dense did not run the shared-memory "
                             "update")
    if estimate_launches < DENSE_STEPS + 1:
        raise AssertionError("estimate launches < update_dense calls + 1")
    if q.launches:
        raise AssertionError("the dense path launched the row-read kernel")
    if tuple(samp.keys.shape) != (L, DENSE_K) \
            or samp.keys.dtype != torch.int32:
        raise AssertionError(f"sample keys shape {tuple(samp.keys.shape)}")
    rate = DENSE_STEPS * live / sum(update_s)
    log(f"[time] update_dense: {DENSE_STEPS} x {live} live elements in "
        f"{sum(update_s):.4f} s = {rate:.4e} elements/s (per call "
        + " ".join(f"{x * 1e3:.1f}" for x in update_s) + f" ms); peak "
        f"memory {peak / 1e6:.1f} MB (reckoned {reckoned / 1e6:.1f} MB) "
        f"{tag}")
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample(DENSE_K)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[time] dense sample(k={DENSE_K}) latency: first {first_ms:.3f} ms, "
        f"5 calls " + " ".join(f"{x:.3f}" for x in sample_ms) + f" ms {tag}")
    st = eng.state
    del eng
    torch.cuda.empty_cache()

    # -- the plain path: worp.onepass_update stream by stream, keys base + i
    # (-1 past the length), same seeds and order -------------------------
    t0 = time.perf_counter()
    st0 = onepass_init_batched(cfg, device=dev)
    offs = torch.arange(n_max, device=dev)
    parts = []
    for b in range(L):
        sb = _map(lambda x: x[b:b + 1], st0)
        keys = torch.where(offs < sizes[b], offs, -1).to(torch.int32)[None]
        for vals in steps:
            sb = worp.onepass_update(
                sb, keys, torch.from_numpy(vals[b:b + 1]).to(dev), cfg.p,
                cfg.scheme)
        parts.append(sb)
    dst = functools.reduce(
        lambda a, c: _map2(lambda x, y: torch.cat([x, y]), a, c), parts)
    del parts, sb, keys
    torch.cuda.synchronize()
    log(f"[dense] plain path (worp.onepass_update, stream by stream): "
        f"{time.perf_counter() - t0:.2f} s")
    cnt = torch.zeros_like(dst.sketch.table)
    mass = torch.zeros_like(dst.sketch.table)
    for vals in steps:
        c, m = ref.countsketch_update_mass_ref(
            torch.from_numpy(vals).to(dev), cfg.rows, cfg.width, seeds, **kw)
        cnt += c
        mass += m
    tol = ref.scatter_tolerance(cnt, mass)
    del cnt, mass, c, m
    bad = compare_tables(torch, "dense segments, kernels vs plain",
                         st.sketch.table, dst.sketch.table, tol)
    compare_samples(torch, "dense segments, kernels vs plain", samp, dst,
                    tol, seeds, DENSE_K, cfg.p, bad)
    del tol, dst

    recalls = []
    for b, n in enumerate(sizes):
        keys = torch.arange(n, dtype=torch.int32, device=dev)
        f = torch.from_numpy(total[b, :n].astype(np.float32)).to(dev)
        tstar = transforms.transform_frequencies(keys, f, cfg.p,
                                                 int(tseeds[b]))
        exact = keys[torch.argsort(tstar.abs(), descending=True,
                                   stable=True)[:DENSE_K]]
        recalls.append(len(set(exact.tolist())
                           & set(samp.keys[b].tolist())) / DENSE_K)
    del keys, f, tstar
    log(f"[main] recall of the exact bottom-{DENSE_K} per stream ("
        + ", ".join(f"{name} {r:.3f}{' (non-finite)' if bool(bad[b]) else ''}"
                    for b, ((name, _), r) in enumerate(zip(LEAVES, recalls)))
        + ")")
    if min(r for b, r in enumerate(recalls) if not bool(bad[b])) < 0.5:
        raise AssertionError("dense sample recall below 0.5 on a finite "
                             "stream")
    profile_dense(torch, cfg, torch.from_numpy(steps[0]).to(dev), sizes, tag)

    # -- the estimate at the refresh's shape: the final tables, the
    # candidates and the segment keys (-1 past each length) ---------------
    offs = torch.arange(n_max, device=dev)
    qkeys = torch.cat([st.cand_keys, torch.where(
        offs < lengths[:, None], offs, -1).to(torch.int32)], 1).contiguous()
    del offs
    check_estimate(torch, "dense refresh shape", st.sketch.table, qkeys,
                   st.sketch.seed)
    torch.cuda.empty_cache()
    est_t = time_estimate(torch, "dense refresh shape", st.sketch.table,
                          qkeys, st.sketch.seed, 5, 1, tag)
    del qkeys
    torch.cuda.empty_cache()

    # -- times of the kernel at the deployment shape -----------------------
    v0 = torch.from_numpy(steps[0]).to(dev)
    u_var = {variant: cuda_ms(torch, lambda: u.countsketch_update_batched(
        v0, cfg.rows, cfg.width, seeds, _variant=variant, **kw), 10)
        for variant in VARIANTS}
    u_ms = u_var["smem"]
    update_plain = lambda: ref.countsketch_update_batched_ref(  # noqa: E731
        v0, cfg.rows, cfg.width, seeds, **kw)
    u_plain = cuda_ms(torch, update_plain, 2, warmup=1)
    # library yardstick, memory half only: index_add_ of the signed,
    # transformed live values at precomputed flat buckets
    idx, sv = [], []
    for b, n in enumerate(sizes):
        keys = torch.arange(n, device=dev)[None]
        tv = transforms.transform_values(keys, v0[b:b + 1, :n], cfg.p,
                                         tseeds[b:b + 1, None])
        i, sg = row_index(torch, keys, seeds[b:b + 1], cfg.width, cfg.rows)
        idx.append(i.reshape(-1) + b * cfg.rows * cfg.width)
        sv.append((sg * tv.repeat(1, cfg.rows)).reshape(-1))
        del keys, tv, i, sg
    idx, sv = torch.cat(idx), torch.cat(sv)
    flat = torch.zeros(L * cfg.rows * cfg.width, device=dev)
    update_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    u_lib = cuda_ms(torch, update_lib, 10)
    del idx, sv, flat, v0
    torch.cuda.empty_cache()
    u_bound, u_by = bound(live * 4 + L * cfg.rows * cfg.width * 4,
                          live * UPDATE_OPS_PER_SLOT)
    plan = plan_of(L, n_max, sizes)
    log(f"[time] update (L={L}, n_max={n_max}, {live} live): kernel "
        f"{u_ms:.4f} ms (shared memory, {plan['blocks']} blocks of "
        f"{plan['chunk']} slots; global atomics {u_var['global']:.4f} ms), "
        f"plain {u_plain:.4f} ms, index_add_ yardstick "
        f"(memory half only) {u_lib:.4f} ms, bound {u_bound:.4f} ms by "
        f"{u_by} ({live * 4 / 1e6:.1f} MB, "
        f"{live * UPDATE_OPS_PER_SLOT / 1e9:.2f} G int ops), "
        f"{100 * u_bound / u_ms:.1f} % of bound {tag}")
    log(f"[phase] 5 dense segments: {time.perf_counter() - t_phase:.2f} s "
        f"wall")
    wg = [name for name, _ in LEAVES].index("wg")
    entry = {
        "name": "countsketch_update_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/countsketch_update.cu",
        "replaces": "src/repro/kernels/countsketch_update.py:240",
        "launches": update_launches, "max_abs_err": u_err,
        "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                  f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
        "worst_err_over_bound": u_ratio,
        "ms": u_ms, "plain_ms": u_plain, "bound_ms": u_bound,
        "bound_by": u_by, "library_ms": u_lib, "variant": "smem",
        "variants": variants_entry("countsketch_update", update_variants,
                                   u_errs, u_var, {"smem": plan})}
    return entry, steps[0][wg, :sizes[wg]], estimate_launches, est_t


def phase_single(torch, wg_values, tag):
    """Phase 6: the single-stream entry points (benchmarks/
    sketch_throughput.py's calls) and ``query_rows_batched`` against their
    plain versions, and times.  Returns the kernels-line entries of the
    single-segment update, the batched and single-table row reads, the
    single-table estimate and the transform."""
    from repro_torch.core import countsketch, hashing, transforms
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ppswor_transform as tr

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    vals = torch.from_numpy(wg_values).to(dev)
    n_big = vals.numel()
    keys_big = torch.arange(n_big, dtype=torch.int32, device=dev)
    qkeys = torch.arange(SINGLE_KEYS, dtype=torch.int32, device=dev)
    vals_bf16 = vals.to(torch.bfloat16)

    # -- the path: counts zeroed just before, read just after --------------
    u.single_launches = q.single_launches = tr.launches = 0
    q.launches = q.estimate_single_launches = 0
    u.variant_launches.update(dict.fromkeys(VARIANTS, 0))
    tr.variant_launches.update(dict.fromkeys(tr.VARIANTS, 0))
    tables = [ops.sketch_dense_vector(vals[:n], ROWS, WIDTH, SINGLE_SEED,
                                      p=P) for n in SINGLE_N]
    rows_out = ops.query_rows(tables[-1], qkeys, SINGLE_SEED)
    est = ops.estimate(tables[-1], qkeys, SINGLE_SEED)
    both = torch.stack(tables)
    both_keys = qkeys.expand(len(SINGLE_N), -1).contiguous()
    both_seeds = torch.full((len(SINGLE_N),), SINGLE_SEED, device=dev)
    rows_both = ops.query_rows_batched(both, both_keys, both_seeds)
    t32 = ops.transform(keys_big, vals, P, 0)
    t16 = ops.transform(keys_big, vals_bf16, P, 0)
    torch.cuda.synchronize()
    launches = {"update": u.single_launches, "query": q.single_launches,
                "estimate": q.estimate_single_launches,
                "query_batched": q.launches, "transform": tr.launches}
    single_variants = dict(u.variant_launches)
    transform_variants = dict(tr.variant_launches)
    log(f"[main] single-stream entry points: sketch_dense_vector launches "
        f"{launches['update']} ({single_variants}), row-read launches "
        f"{launches['query']} (one table) and {launches['query_batched']} "
        f"(query_rows_batched), estimate launches {launches['estimate']}, "
        f"transform launches {launches['transform']} ({transform_variants})")
    if launches != {"update": len(SINGLE_N), "query": 1, "estimate": 1,
                    "query_batched": 1, "transform": 2}:
        raise AssertionError("single-stream launches do not match the calls")
    if single_variants["smem"] != len(SINGLE_N):
        raise AssertionError("sketch_dense_vector did not run the "
                             "shared-memory update")
    if transform_variants["vector"] != 2:
        raise AssertionError("the aligned transforms did not run the vector "
                             "variant")

    # -- parity against the plain versions ---------------------------------
    u_err, single_errs = 0.0, {}
    for n, table in zip(SINGLE_N, tables):
        want = ref.countsketch_update_ref(vals[:n], 0, ROWS, WIDTH,
                                          SINGLE_SEED, p=P)
        tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
            vals[None, :n], ROWS, WIDTH, SINGLE_SEED, p=P))[0]
        single_errs["smem"] = check_sum(
            torch, f"sketch_dense_vector n={n} [smem]", table, want, tol)
        u_err = max(u_err, single_errs["smem"][0])
    # the global variant of #4 at n = 21.2 M, against the same plain table
    before = dict(u.variant_launches)
    got = u.countsketch_update(vals, ROWS, WIDTH, SINGLE_SEED, p=P,
                               _variant="global")
    if launched(u, before) != "global":
        raise AssertionError("the forced global update did not launch")
    single_errs["global"] = check_sum(torch, f"sketch_dense_vector n={n} "
                                      f"[global]", got, want, tol)
    del got
    check_bitwise(torch, f"query_rows k={SINGLE_KEYS}", rows_out,
                  ref.countsketch_query_ref(tables[-1], qkeys, SINGLE_SEED))
    check_bitwise(torch, f"estimate k={SINGLE_KEYS}", est,
                  ref.countsketch_estimate_ref(tables[-1], qkeys,
                                               SINGLE_SEED))
    check_bitwise(torch, f"query_rows_batched B={len(SINGLE_N)} "
                  f"k={SINGLE_KEYS}", rows_both,
                  ref.countsketch_query_batched_ref(both, both_keys,
                                                    both_seeds))
    del rows_both

    t_err = {"float32": 0.0, "bfloat16": 0.0}

    def check_transform(name, got, keys, v, p):
        """The transform against its plain version: allclose at the
        tolerances of tests/test_kernels.py, and the same infinities, with
        their signs, where the plain version has them."""
        rtol, atol = (1e-5, 1e-6) if v.dtype == torch.float32 \
            else (2e-2, 1e-2)
        want = ref.ppswor_transform_ref(keys, v, p, 0)
        torch.cuda.synchronize()
        g32, w32 = got.float(), want.float()
        fin = w32.isfinite()
        same_nonfinite = bool(((g32 == w32) | (g32.isnan() & w32.isnan()))[
            ~fin].all())
        ok = got.dtype == want.dtype and same_nonfinite and torch.allclose(
            g32, w32, rtol=rtol, atol=atol, equal_nan=True)
        err = float((g32 - w32)[fin].abs().max()) if fin.any() else 0.0
        dt = "float32" if v.dtype == torch.float32 else "bfloat16"
        t_err[dt] = max(t_err[dt], err)
        log(f"[parity] transform {name} {dt} p={p} n={v.numel()}: "
            f"max_abs_err {err:.3e}; allclose rtol {rtol} atol {atol} and "
            f"the same +-inf: {'ok' if ok else 'FAIL'}; nonfinite "
            f"{int((~fin).sum())} ("
            + ", ".join(f"{x:g}" for x in w32[~fin][:4].tolist()) + ")")
        if not ok:
            raise AssertionError(f"transform {name} {dt} p={p}: the kernel "
                                 f"disagrees with its plain version")

    edge = int(ref.ppswor_transform_ref(
        torch.tensor([EDGE_KEY], dtype=torch.int32, device=dev),
        torch.ones(1, device=dev), 1.0, 0).isinf().all())
    log(f"[parity] transform: key {EDGE_KEY} hits the uniform01 == 1.0 "
        f"edge under seed 0: {bool(edge)}; it is among the n={n_big} keys: "
        f"{EDGE_KEY < n_big}")
    check_transform("path", t32, keys_big, vals, P)
    check_transform("path", t16, keys_big, vals_bf16, P)
    path_err = dict(t_err)
    del t32, t16
    for v in (vals, vals_bf16):
        # the tensors (vector), views that start 4 (or 2) bytes in (scalar,
        # by alignment; n - 1 is not a multiple of the vector width), and a
        # prefix n - 3 long (the vector loop's tail)
        for variant, what, cut, ps in (
                ("vector", "", slice(None), TRANSFORM_PS),
                ("scalar", " view [1:]", slice(1, None), TRANSFORM_PS),
                ("vector", f" prefix [:{n_big - 3}]", slice(n_big - 3),
                 (P,))):
            for p in ps:
                before = dict(tr.variant_launches)
                got = ops.transform(keys_big[cut], v[cut], p, 0)
                if tr.variant_launches[variant] != before[variant] + 1:
                    raise AssertionError(f"transform: {variant} did not "
                                         f"launch")
                check_transform(variant + what, got, keys_big[cut], v[cut],
                                p)
                del got
    del rows_out, est

    # -- times -------------------------------------------------------------
    table = tables[-1]
    single_ms = {variant: cuda_ms(torch, lambda: u.countsketch_update(
        vals, ROWS, WIDTH, SINGLE_SEED, p=P, _variant=variant), 20)
        for variant in VARIANTS}
    upd_plain = lambda: ref.countsketch_update_ref(  # noqa: E731
        vals, 0, ROWS, WIDTH, SINGLE_SEED, p=P)
    tv = transforms.transform_values(keys_big, vals, P, 0)
    sd = torch.tensor([SINGLE_SEED], device=dev)
    idx, sign = row_index(torch, keys_big[None], sd, WIDTH)
    idx, sv = idx.reshape(-1), (sign * tv.repeat(1, ROWS)).reshape(-1)
    flat = torch.zeros(ROWS * WIDTH, device=dev)
    upd_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    s_ms = single_ms["smem"]
    s_plain = cuda_ms(torch, upd_plain, 3, warmup=1)
    s_lib = cuda_ms(torch, upd_lib, 20)
    del tv, idx, sign, sv, flat
    s_bound, s_by = bound(n_big * 4 + ROWS * WIDTH * 4,
                          n_big * UPDATE_OPS_PER_SLOT)

    qry = lambda: ops.query_rows(table, qkeys, SINGLE_SEED)  # noqa: E731
    qry_plain = lambda: ref.countsketch_query_ref(  # noqa: E731
        table, qkeys, SINGLE_SEED)
    gidx = gather_index(torch, qkeys[None], sd, WIDTH).reshape(-1)
    flat_table = table.reshape(-1)
    qry_lib = lambda: torch.gather(flat_table, 0, gidx)  # noqa: E731
    # one call keeps the card busy for microseconds, so CUDA events over
    # back-to-back calls time the host; the device time comes from a trace
    q_call = (cuda_ms(torch, qry, 200, warmup=5),
              cuda_ms(torch, qry_plain, 50, warmup=5),
              cuda_ms(torch, qry_lib, 200, warmup=5))
    q_ms, q_plain, q_lib = (device_ms(torch, f, 50) or t for f, t in zip(
        (qry, qry_plain, qry_lib), q_call))
    read = table_bytes_read(torch, table[None], qkeys[None], sd)
    q_bound, q_by = bound(SINGLE_KEYS * 4 + read + ROWS * SINGLE_KEYS * 4,
                          SINGLE_KEYS * QUERY_OPS_PER_KEY)
    # the batched row read at the shape query_rows_batched launched it
    nb = both_keys.numel()
    bgidx = gather_index(torch, both_keys, both_seeds, WIDTH)
    both_flat = both.reshape(len(SINGLE_N), -1)
    qb_fns = (
        lambda: ops.query_rows_batched(both, both_keys, both_seeds),
        lambda: ref.countsketch_query_batched_ref(both, both_keys,
                                                  both_seeds),
        lambda: torch.gather(both_flat, 1, bgidx))
    qb_call = [cuda_ms(torch, f, 200, warmup=5) for f in qb_fns]
    qb_ms, qb_plain, qb_lib = (device_ms(torch, f, 50) or t
                               for f, t in zip(qb_fns, qb_call))
    qb_bound, qb_by = bound(
        nb * 4 + table_bytes_read(torch, both, both_keys, both_seeds)
        + ROWS * nb * 4, nb * QUERY_OPS_PER_KEY)
    # the estimate: its kernel against the row read and the plain median
    # (one launch against eight), device time per call from a trace
    e_fns = {
        "estimate": lambda: ops.estimate(table, qkeys, SINGLE_SEED),
        "row_read_median": lambda: countsketch.median(
            ops.query_rows(table, qkeys, SINGLE_SEED), 0),
        "plain": lambda: ref.countsketch_estimate_ref(table, qkeys,
                                                      SINGLE_SEED)}
    e_call = {name: cuda_ms(torch, f, 200, warmup=5)
              for name, f in e_fns.items()}
    e_t = {name: device_ms(torch, f, 50) or e_call[name]
           for name, f in e_fns.items()}
    e_bound, e_by = bound(SINGLE_KEYS * 8 + read,
                          SINGLE_KEYS * ESTIMATE_OPS_PER_KEY)

    # the transform at p = 1 (a reciprocal) and p = 1.5 (powf), both
    # variants; the plain version and the yardstick at p = 1
    factor = transforms._pow32(hashing.exp1(keys_big, 0), -1.0 / P)
    t_times = {}
    for name, v, width in (("float32", vals, 4), ("bfloat16", vals_bf16, 2)):
        f = factor.to(v.dtype)
        # the scalar variant on views that start one element in (n - 1)
        t = {(p, variant): cuda_ms(torch, lambda: tr.ppswor_transform(
            keys_big[cut], v[cut], p, 0), 20)
            for p in (1.0, 1.5) for variant, cut in (
                ("vector", slice(None)), ("scalar", slice(1, None)))}
        t["plain"] = cuda_ms(torch, lambda: ref.ppswor_transform_ref(
            keys_big, v, P, 0), 3, warmup=1)
        t["library"] = cuda_ms(torch, lambda: torch.mul(v, f), 20)
        t["bound"], t["bound_by"] = bound(n_big * (4 + 2 * width),
                                          n_big * TRANSFORM_OPS_PER_ELEM)
        t_times[name] = t
        del f
    del factor
    plan = plan_of(1, n_big, None)
    log(f"[time] sketch_dense_vector (n={n_big}): kernel {s_ms:.4f} ms "
        f"(shared memory, {plan['blocks']} blocks of {plan['chunk']} slots; "
        f"global atomics {single_ms['global']:.4f} ms), plain "
        f"{s_plain:.4f} ms, index_add_ yardstick (memory half only) "
        f"{s_lib:.4f} ms, bound {s_bound:.4f} ms by {s_by}, "
        f"{100 * s_bound / s_ms:.1f} % of bound {tag}")
    log(f"[time] query_rows (k={SINGLE_KEYS}), device time per call "
        f"(traced): kernel {q_ms:.4f} ms, plain {q_plain:.4f} ms, gather "
        f"yardstick (memory half only) {q_lib:.4f} ms, bound {q_bound:.6f} "
        f"ms by {q_by}; per call by CUDA events (host-bound): kernel "
        f"{q_call[0]:.4f} ms, plain {q_call[1]:.4f} ms, gather "
        f"{q_call[2]:.4f} ms {tag}")
    log(f"[time] query_rows_batched (B={len(SINGLE_N)}, k={SINGLE_KEYS}), "
        f"device time per call (traced): kernel {qb_ms:.4f} ms, plain "
        f"{qb_plain:.4f} ms, gather yardstick (memory half only) "
        f"{qb_lib:.4f} ms, bound {qb_bound:.6f} ms by {qb_by}; per call by "
        f"CUDA events (host-bound): kernel {qb_call[0]:.4f} ms, plain "
        f"{qb_call[1]:.4f} ms, gather {qb_call[2]:.4f} ms {tag}")
    log(f"[time] estimate (k={SINGLE_KEYS}), device time per call "
        f"(traced): estimate kernel {e_t['estimate']:.4f} ms, row read + "
        f"countsketch.median {e_t['row_read_median']:.4f} ms, plain "
        f"{e_t['plain']:.4f} ms, bound {e_bound:.6f} ms by {e_by}; per call "
        f"by CUDA events (host-bound): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in e_call.items()) + f" {tag}")
    for name, t in t_times.items():
        log(f"[time] transform {name} (n={n_big}): p=1 vector "
            f"{t[(1.0, 'vector')]:.4f} ms, scalar (n-1, a view one element "
            f"in) {t[(1.0, 'scalar')]:.4f} ms; p=1.5 vector "
            f"{t[(1.5, 'vector')]:.4f} ms, scalar {t[(1.5, 'scalar')]:.4f} "
            f"ms; plain (p=1) {t['plain']:.4f} ms, torch.mul by precomputed "
            f"factors {t['library']:.4f} ms, bound {t['bound']:.4f} ms by "
            f"{t['bound_by']}, "
            f"{100 * t['bound'] / t[(1.0, 'vector')]:.1f} % of bound at p=1 "
            f"(vector) {tag}")
    log(f"[phase] 6 single-stream entry points: "
        f"{time.perf_counter() - t_phase:.2f} s wall")
    f32, bf16 = t_times["float32"], t_times["bfloat16"]

    def transform_variants_entry(t):
        return {v: {"launches": transform_variants[v], "ms": t[(1.0, v)],
                    "ms_p1.5": t[(1.5, v)]} for v in tr.VARIANTS}
    return [
        {"name": "countsketch_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_update.cu",
         "replaces": "src/repro/kernels/countsketch_update.py:102",
         "launches": launches["update"], "max_abs_err": u_err,
         "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                   f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib, "variant": "smem",
         "variants": variants_entry("countsketch_update", single_variants,
                                    single_errs, single_ms, {"smem": plan})},
        {"name": "countsketch_query", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:66",
         "launches": launches["query"], "max_abs_err": 0.0,
         "parity": "bitwise", "ms": q_ms, "plain_ms": q_plain,
         "bound_ms": q_bound, "bound_by": q_by, "library_ms": q_lib,
         "timing": "device time per call from a torch.profiler trace",
         "call_ms": q_call[0]},
        {"name": "countsketch_query_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:150",
         "launches": launches["query_batched"], "max_abs_err": 0.0,
         "parity": "bitwise", "ms": qb_ms, "plain_ms": qb_plain,
         "bound_ms": qb_bound, "bound_by": qb_by, "library_ms": qb_lib,
         "timing": "device time per call from a torch.profiler trace, at "
                   "query_rows_batched's shape",
         "call_ms": qb_call[0]},
        {"name": "countsketch_estimate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:66",
         "launches": launches["estimate"], "max_abs_err": 0.0,
         "parity": "equal under == (NaN equal to NaN) to countsketch.median "
                   "of the plain reads",
         "ms": e_t["estimate"], "plain_ms": e_t["plain"],
         "bound_ms": e_bound, "bound_by": e_by, "library_ms": q_lib,
         "row_read_median_ms": e_t["row_read_median"],
         "timing": "device time per call from a torch.profiler trace",
         "call_ms": e_call["estimate"]},
        {"name": "ppswor_transform", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ppswor_transform.cu",
         "replaces": "src/repro/kernels/ppswor_transform.py:32",
         "launches": launches["transform"],
         "max_abs_err": path_err["float32"],
         "max_abs_err_any_p": t_err["float32"],
         "parity": "float32 rtol 1e-5 atol 1e-6; bfloat16 rtol 2e-2 "
                   "atol 1e-2; the plain version's +-inf equal, signs "
                   "included; p = 0.5, 1, 1.5, 2",
         "ms": f32[(1.0, "vector")], "plain_ms": f32["plain"],
         "bound_ms": f32["bound"], "bound_by": f32["bound_by"],
         "library_ms": f32["library"], "variant": "vector",
         "variants": transform_variants_entry(f32),
         "bf16_max_abs_err": path_err["bfloat16"],
         "bf16_ms": bf16[(1.0, "vector")], "bf16_plain_ms": bf16["plain"],
         "bf16_bound_ms": bf16["bound"], "bf16_library_ms": bf16["library"],
         "bf16_variants": transform_variants_entry(bf16)},
    ]


# -- the samplers phase ---------------------------------------------------

def reset_counts() -> None:
    """Every kernel wrapper's launch counters to 0."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ppswor_transform as tr
    from repro_torch.kernels import segment_sum as sg

    s.launches = u.launches = u.single_launches = tr.launches = 0
    q.launches = q.single_launches = 0
    q.estimate_launches = q.estimate_single_launches = 0
    sg.launches = 0
    for m in (s, u, tr):
        m.variant_launches.update(dict.fromkeys(m.variant_launches, 0))


def read_counts() -> dict:
    """The launch counters: the scatter (and its variants), the estimate,
    the batched row read, the segment sum, and every other kernel's
    launches summed."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ppswor_transform as tr
    from repro_torch.kernels import segment_sum as sg

    return {"scatter": s.launches, "smem": s.variant_launches["smem"],
            "global": s.variant_launches["global"],
            "det": s.variant_launches["det"], "segment_sum": sg.launches,
            "estimate": q.estimate_launches, "row_read": q.launches,
            "other": (q.single_launches + q.estimate_single_launches
                      + u.launches + u.single_launches + tr.launches)}


def since(before: dict) -> dict:
    now = read_counts()
    return {k: now[k] - before[k] for k in now}


def expect_counts(what, got: dict, scatter=0, estimate=0):
    """Raise unless the launches are exactly ``scatter`` shared-memory
    scatters and ``estimate`` estimate-kernel launches, and nothing else."""
    want = {"scatter": scatter, "smem": scatter, "global": 0, "det": 0,
            "segment_sum": 0, "estimate": estimate, "row_read": 0,
            "other": 0}
    log(f"[main] {what}: launches {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def sub_view(st):
    """The first SUB_B streams of a batched state or sample, as views (no
    path writes into a state's tensors: a flush makes new ones)."""
    from repro_torch.engine.engine import _map

    return _map(lambda x: x[:SUB_B], st)


def flush_tolerance(torch, old_table, keys, vals, seeds, tseeds):
    """Each cell's rounding bound for one flush into ``old_table``: the
    flush's terms and the old value, in any order."""
    from repro_torch.kernels import ref

    rows, width = old_table.shape[-2:]
    cnt, mass = ref.countsketch_scatter_mass_ref(keys, vals, rows, width,
                                                 seeds, p=P,
                                                 transform_seeds=tseeds)
    return ref.scatter_tolerance(cnt + 1, mass + old_table.abs())


def near_tie_streams(torch, keys, prio, err, c: int):
    """(B,) streams whose c-th and (c+1)-st distinct priorities under the
    buffer policy (``worp._dedup_topc``) lie within the sum of their
    errors, ``err(keys)``: where rounding may swap the key kept."""
    from repro_torch.core import worp

    k2, _, p2 = worp._dedup_topc(keys, torch.zeros_like(prio), prio, c + 1)
    e2 = err(k2)
    return (p2[:, c - 1] - p2[:, c]) <= (e2[:, c - 1] + e2[:, c])


def same_sets(torch, a, b):
    return (torch.sort(a, 1).values == torch.sort(b, 1).values).all(1)


def check_flush_table(torch, what, got, want, tol, scale, stats):
    """A flush's kernel tables (of the first SUB_B streams) against the
    plain update's from the same state, within both bounds.  The
    scale-aware one takes its scale from the deployment's tables before
    and after the flush (``scale``, all B streams): a retraction can take
    a cell from the largest value back to about zero, leaving the rounding
    of that value behind.  Returns the streams whose plain tables hold
    non-finite cells (the uniform01 == 1.0 edge)."""
    atol = max(scale_atol(t) for t in scale)
    close = torch.allclose(got, want, rtol=RTOL, atol=atol, equal_nan=True)
    cells, err, ratio = cell_check(torch, got, want, tol)
    if not (close and cells):
        over = torch.where(want.isfinite(), (got - want).abs()
                           - RTOL * want.abs(), 0.0).flatten()
        i = int(over.argmax())
        raise AssertionError(
            f"{what} tables disagree (max_abs_err {err:.3e}, worst err/bound"
            f" {ratio:.3e}; allclose atol {atol:.3e}, worst cell {i}: got "
            f"{float(got.flatten()[i])!r} want {float(want.flatten()[i])!r} "
            f"bound {float(tol.flatten()[i])!r})")
    st = stats.setdefault(what, {"max_abs_err": 0.0, "ratio": 0.0})
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["ratio"] = max(st["ratio"], ratio)
    return (~want.isfinite()).flatten(1).any(1)


def check_buffer(torch, what, got_keys, want_keys, all_keys, prio, err, c,
                 bad, stats):
    """A flush's kernel buffer (candidates, or the pass-II keys) against the
    plain update's as key sets: a stream may differ only in a near tie of
    its c-th and (c+1)-st priorities, or where its plain table is not
    finite."""
    same = same_sets(torch, got_keys, want_keys)
    near = near_tie_streams(torch, all_keys, prio, err, c)
    outside = int((~same & ~near & ~bad).sum())
    st = stats.setdefault(what, {"checked": 0, "differ": 0, "near_tie": 0})
    st["checked"] += same.numel()
    st["differ"] += int((~same).sum())
    st["near_tie"] += int(near.sum())
    if outside:
        raise AssertionError(f"{what}: {outside} streams differ from the "
                             f"plain path outside near ties")
    return same


def check_refresh(torch, what, got_cand, want_sk, want_cand, old_cand, keys,
                  tol, bad, stats):
    """The candidate refresh of one flush (top-C of old candidates U batch
    keys by |estimate|)."""
    from repro_torch.core import countsketch
    from repro_torch.kernels import ref

    all_keys = torch.cat([old_cand, keys], 1)
    est = countsketch.estimate(want_sk, all_keys).abs()
    prio = torch.where(all_keys == -1, float("-inf"), est)

    def err(k):
        return ref.countsketch_query_batched_ref(tol, k, want_sk.seed).abs(
            ).amax(1)

    check_buffer(torch, what, got_cand, want_cand, all_keys, prio, err,
                 old_cand.shape[1], bad, stats)
    return err


def check_twopass_flush(torch, spec, old, full, keys, vals, stats):
    """One ``twopass`` flush of the kernels (the engine's states ``old``
    before and ``full`` after it, their first SUB_B streams) against the
    plain update of the same state: pass-I tables and candidates, pass-II
    keys, and the exact frequencies of equal buffers bit for bit (the
    stream's values are +-1)."""
    from repro_torch.core import countsketch

    snap, got = sub_view(old), sub_view(full)
    want = spec.update(snap, keys, torch.where(keys == -1, 0.0, vals))
    sk0 = snap.pass1.sketch
    tol = flush_tolerance(torch, sk0.table, keys, vals, sk0.seed,
                          snap.pass1.seed_transform)
    bad = check_flush_table(torch, "twopass pass I", got.pass1.sketch.table,
                            want.pass1.sketch.table, tol,
                            (old.pass1.sketch.table, full.pass1.sketch.table),
                            stats)
    err = check_refresh(torch, "twopass pass-I candidates",
                        got.pass1.cand_keys, want.pass1.sketch,
                        want.pass1.cand_keys, snap.pass1.cand_keys, keys,
                        tol, bad, stats)
    # pass II: top-capacity of (buffer U batch keys) by online priority
    est = countsketch.estimate(want.pass1.sketch, keys).abs()
    all_keys = torch.cat([snap.pass2.keys, keys], 1)
    prio = torch.cat([snap.pass2.priority,
                      torch.where(keys == -1, float("-inf"), est)], 1)
    same = check_buffer(torch, "twopass pass-II keys", got.pass2.keys,
                        want.pass2.keys, all_keys, prio, err,
                        snap.pass2.keys.shape[1], bad, stats)
    gk, gi = torch.sort(got.pass2.keys, 1)
    wk, wi = torch.sort(want.pass2.keys, 1)
    equal = (torch.gather(got.pass2.freqs, 1, gi)
             == torch.gather(want.pass2.freqs, 1, wi)).all(1)
    if bool((same & ~equal).any()):
        raise AssertionError("twopass pass-II frequencies differ from the "
                             "plain path's")
    return bad


def check_tv_flush(torch, spec, old, full, keys, vals, stats):
    """One ``tv`` flush of the kernels against the plain update of the same
    state: the B x r cascade tables and candidates, the rHH's."""
    from repro_torch.core import countsketch

    snap, got = sub_view(old), sub_view(full)
    want = spec.update(snap, keys, torch.where(keys == -1, 0.0, vals))
    Bs, r = snap.transform_seeds.shape

    def flat(t):
        return t.reshape((Bs * r,) + t.shape[2:])

    kf, vf = keys.repeat_interleave(r, 0), vals.repeat_interleave(r, 0)
    tol = flush_tolerance(torch, flat(snap.sketches.table), kf, vf,
                          flat(snap.sketches.seed),
                          flat(snap.transform_seeds))
    bad_f = check_flush_table(torch, "tv cascade", flat(got.sketches.table),
                              flat(want.sketches.table), tol,
                              (old.sketches.table, full.sketches.table),
                              stats)
    check_refresh(torch, "tv cascade candidates", flat(got.cand_keys),
                  countsketch.CountSketch(table=flat(want.sketches.table),
                                          seed=flat(want.sketches.seed)),
                  flat(want.cand_keys), flat(snap.cand_keys), kf, tol, bad_f,
                  stats)
    sk0 = snap.rhh.sketch
    tol = flush_tolerance(torch, sk0.table, keys, vals, sk0.seed,
                          snap.rhh.seed_transform)
    bad_r = check_flush_table(torch, "tv rHH", got.rhh.sketch.table,
                              want.rhh.sketch.table, tol,
                              (old.rhh.sketch.table, full.rhh.sketch.table),
                              stats)
    check_refresh(torch, "tv rHH candidates", got.rhh.cand_keys,
                  want.rhh.sketch, want.rhh.cand_keys, snap.rhh.cand_keys,
                  keys, tol, bad_r, stats)
    return bad_f.reshape(Bs, r).any(1) | bad_r


def sampler_engine(name: str, num_streams: int = None):
    from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine

    return SketchEngine(
        EngineConfig(num_streams=num_streams or B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P, sampler=name,
                     domain=VOCAB),
        flush=FlushPolicy(max_elems=4096), device=DEVICE)


def traced_ms(torch, fn, what, tag) -> float | None:
    """Device busy ms of one call of ``fn`` from a torch.profiler trace
    (its stage ranges, kernels by name and busy share printed; None when
    the profiler saw no device time); the trace must hold no sort over
    rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = trace_report(prof, RANGES, wall_ms, what, tag, top=8)
    check_no_row_sort(rows, what)
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    return busy if rows else None


def profile_sampler(torch, name, steps, k, tag, num_streams=None):
    """A fresh engine of ``name``: one flush, then a second flush and a
    sample each in a trace.  Returns their device ms."""
    eng = sampler_engine(name, num_streams)
    n = num_streams or B
    eng.ingest(steps[0][0][:n], steps[0][1][:n])
    flush_ms = traced_ms(torch, lambda: eng.ingest(steps[1][0][:n],
                                                   steps[1][1][:n]),
                         f"{name}, 1 flush", tag)
    sample_ms = traced_ms(torch, lambda: eng.sample(k),
                          f"{name}, sample(k={k})", tag)
    return flush_ms, sample_ms


def drive_sampler(torch, name, steps, k, check_flush, tag):
    """The main path of sampler ``name`` at B streams: ingest the steps
    (each fills one flush) and sample, with the launches counted; after
    each flush, outside the timed calls, the first SUB_B streams against
    the plain update of the state before it (``check_flush``)."""
    dev = torch.device(DEVICE)
    eng = sampler_engine(name)
    stats, bad = {}, None
    ingest_s, flushes, peak = 0.0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    for keys, vals in steps:
        old = eng.state  # a flush makes new tensors: this one stays intact
        before = read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.ingest(keys, vals)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated())
        flushes += eng.pending == 0
        ran = since(before)
        kt = torch.from_numpy(keys[:SUB_B]).to(dev)
        vt = torch.from_numpy(vals[:SUB_B]).to(dev)
        b = check_flush(torch, eng.spec, old, eng.state, kt, vt, stats)
        if since(before) != ran:
            raise AssertionError("the plain reference launched a kernel")
        bad = b if bad is None else bad | b
        del old, kt, vt
    ingest_counts = read_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samp = eng.sample(k)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = max(peak, torch.cuda.max_memory_allocated())
    sample_counts = since(ingest_counts)
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample(k)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    events = sum(kk.size for kk, _ in steps)
    for what, st in stats.items():
        log(f"[main] {name} vs plain, {what}: {st}")
    log(f"[time] {name} sparse plane: {flushes} flushes, {events} events in "
        f"{ingest_s:.4f} s = {events / ingest_s:.4e} events/s; sample(k={k})"
        f" first {first_ms:.3f} ms, 5 calls "
        + " ".join(f"{x:.3f}" for x in sample_ms) + f" ms; peak memory "
        f"{peak / 1e6:.1f} MB {tag}")
    return {"eng": eng, "sample": samp, "bad": bad, "flushes": flushes,
            "ingest": ingest_counts, "sample_launches": sample_counts,
            "events_per_s": events / ingest_s, "sample_ms": sample_ms,
            "first_sample_ms": first_ms, "peak_mb": peak / 1e6,
            "stats": stats}


def phase_samplers(torch, steps, stream, tag):
    """The samplers phase: ``twopass`` and ``tv`` on the sparse plane,
    ``onepass`` with freeze/update_pass2/sample_exact, and ``perfect``, at
    the sparse plane's deployment, each against the plain path on the
    first SUB_B streams; the scatter and the estimate at the TV cascade's
    shapes.  Returns the launches of each kernel on these paths and the
    kernels-line records of the new shapes."""
    import numpy as np

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    launches = {"scatter": 0, "smem": 0, "estimate": 0}
    out = {}

    def add(counts):
        for key in launches:
            launches[key] += counts[key]

    # -- twopass, sparse plane -------------------------------------------
    tp = drive_sampler(torch, "twopass", steps, K, check_twopass_flush, tag)
    f = tp["flushes"]
    expect_counts(f"twopass, {f} flushes", tp["ingest"], scatter=f,
                  estimate=2 * f)
    expect_counts("twopass sample", tp["sample_launches"])
    add(tp["ingest"])
    want = tp["eng"].spec.sample(sub_view(tp["eng"].state), K)
    got = sub_view(tp["sample"])
    if not (torch.equal(got.keys, want.keys)
            and torch.equal(got.freqs, want.freqs)):
        raise AssertionError("twopass sample differs from the plain "
                             "sample of the same state")
    log(f"[main] twopass sample(k={K}) of the first {SUB_B} streams: keys and"
        f" exact frequencies equal to the plain sample; streams with "
        f"non-finite cells {int(tp['bad'].sum())}")
    out["twopass"] = {k: tp[k] for k in ("events_per_s", "sample_ms",
                                         "first_sample_ms", "peak_mb")}
    del tp
    torch.cuda.empty_cache()
    out["twopass"]["flush_ms"], out["twopass"]["traced_sample_ms"] = \
        profile_sampler(torch, "twopass", steps, K, tag)

    # -- tv, sparse plane --------------------------------------------------
    tv = drive_sampler(torch, "tv", steps, TV_K, check_tv_flush, tag)
    f = tv["flushes"]
    r = tv["eng"].cfg.num_samplers
    expect_counts(f"tv, {f} flushes", tv["ingest"], scatter=2 * f,
                  estimate=2 * f)
    expect_counts(f"tv sample ({r} draws and the rHH read)",
                  tv["sample_launches"], estimate=r + 1)
    add(tv["ingest"])
    add(tv["sample_launches"])
    want = tv["eng"].spec.sample(sub_view(tv["eng"].state), TV_K)
    got = sub_view(tv["sample"])
    if not torch.equal(got.keys, want.keys):
        raise AssertionError("tv sample keys differ from the plain sample of "
                             "the same state")
    if not bool(tv["sample"].threshold.isnan().all()):
        raise AssertionError("tv sample threshold is not NaN")
    fresh = (tv["sample"].keys != -1).sum(1).float()
    log(f"[main] tv sample(k={TV_K}) of the first {SUB_B} streams: keys "
        f"equal to the plain sample's (estimate kernel == plain median); "
        f"threshold NaN; fresh draws a stream mean {float(fresh.mean()):.3f}"
        f" min {int(fresh.min())}; streams with non-finite cells "
        f"{int(tv['bad'].sum())}")
    out["tv"] = {k: tv[k] for k in ("events_per_s", "sample_ms",
                                    "first_sample_ms", "peak_mb")}
    tv_state = tv["eng"].state
    del tv
    torch.cuda.empty_cache()
    out["tv"]["flush_ms"], out["tv"]["traced_sample_ms"] = profile_sampler(
        torch, "tv", steps, TV_K, tag)

    # -- the scatter and the estimate at the TV cascade's shapes ----------
    out["tv_shapes"] = time_tv_shapes(torch, tv_state, steps, tag)
    del tv_state
    torch.cuda.empty_cache()

    # -- perfect, sparse plane, on the sub-batch: no kernel ----------------
    pe = sampler_engine("perfect", SUB_B)
    reset_counts()
    before = read_counts()
    t0 = time.perf_counter()
    for keys, vals in steps:
        pe.ingest(keys[:SUB_B], vals[:SUB_B])
    pe.flush()
    torch.cuda.synchronize()
    perfect_s = time.perf_counter() - t0
    expect_counts("perfect, sparse plane (no sketch, no kernel)",
                  since(before))
    devices = {t.device.type for t in (pe.state.freqs,
                                       pe.state.seed_transform)}
    if devices != {dev.type}:
        raise AssertionError(f"perfect state on {devices}")
    for b in range(4):
        agg = stream.aggregate_freqs(b, STEPS, INSERTS).astype(np.float32)
        if not np.array_equal(pe.state.freqs[b].cpu().numpy(), agg):
            raise AssertionError("perfect frequencies differ from the "
                                 "stream's aggregate")
    exact = pe.sample(K)
    out["perfect"] = {"ingest_s": perfect_s}
    out["perfect"]["flush_ms"], out["perfect"]["traced_sample_ms"] = \
        profile_sampler(torch, "perfect", steps, K, tag, num_streams=SUB_B)
    log(f"[main] perfect (B={SUB_B}, domain {VOCAB}): state on the card, no "
        f"kernel launched, frequencies equal to the stream's aggregate "
        f"(streams 0-3); {STEPS} steps in {perfect_s:.4f} s {tag}")

    # -- onepass: freeze, update_pass2, sample_exact -----------------------
    eng = sampler_engine("onepass")
    for keys, vals in steps:
        eng.ingest(keys, vals)
    eng.freeze()
    spec = eng.spec
    frozen = sub_view(eng.state)  # pass II leaves it as it is
    plain2 = spec.init2(frozen)
    reset_counts()
    call_ms = []
    for keys, vals in steps:
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.update_pass2(keys, vals)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        expect_counts("update_pass2 call", since(before), estimate=1)
        plain2 = spec.update2(plain2, frozen,
                              torch.from_numpy(keys[:SUB_B]).to(dev),
                              torch.from_numpy(vals[:SUB_B]).to(dev))
    add(read_counts())
    before = read_counts()
    t0 = time.perf_counter()
    samp = eng.sample_exact(K)
    torch.cuda.synchronize()
    exact_ms = [(time.perf_counter() - t0) * 1e3]
    for _ in range(5):
        t0 = time.perf_counter()
        eng.sample_exact(K)
        torch.cuda.synchronize()
        exact_ms.append((time.perf_counter() - t0) * 1e3)
    expect_counts("sample_exact", since(before))
    got2 = sub_view(eng.pass2)
    if not all(torch.equal(a, b) for a, b in zip(got2, plain2)):
        raise AssertionError("pass-II buffers differ from the plain path's "
                             "(the priorities are estimates equal under ==)")
    want = spec.sample2(plain2, K)
    sub = sub_view(samp)
    if not (torch.equal(sub.keys, want.keys)
            and torch.equal(sub.freqs, want.freqs)):
        raise AssertionError("sample_exact differs from the plain path's")
    live = sub.keys != -1
    agg = torch.gather(pe.state.freqs, 1,
                       torch.where(live, sub.keys, 0).to(torch.int64))
    if not bool(torch.isclose(sub.freqs, agg, rtol=1e-5)[live].all()):
        raise AssertionError("sample_exact frequencies are not the stream's "
                             "exact aggregated frequencies")
    ex = exact.keys
    hit = (sub.keys[:, :, None] == ex[:, None, :]).any(2).sum(1).float() / K
    finite = frozen.sketch.table.isfinite().flatten(1).all(1)
    fin = hit[finite]
    n_exact = int((same_sets(torch, sub.keys, ex) & finite).sum())
    log(f"[main] onepass freeze -> {STEPS} x update_pass2 -> sample_exact("
        f"k={K}): pass-II buffers and sample equal to the plain path's on "
        f"{SUB_B} streams; sampled frequencies equal the exact aggregate; "
        f"recall of the perfect oracle's bottom-{K} over the "
        f"{int(finite.sum())}"
        f" finite streams: mean {float(fin.mean()):.4f} min "
        f"{float(fin.min()):.4f}, {n_exact} streams exact")
    if float(fin.min()) < 0.5:
        raise AssertionError("exact two-pass recall below 0.5")
    log(f"[time] update_pass2 (B={B}, n=5120 a call): "
        + " ".join(f"{x:.3f}" for x in call_ms) + f" ms; sample_exact(k={K})"
        f" first {exact_ms[0]:.3f} ms, 5 calls "
        + " ".join(f"{x:.3f}" for x in exact_ms[1:]) + f" ms {tag}")
    out["onepass_pass2"] = {"update_pass2_ms": call_ms,
                            "sample_exact_ms": exact_ms,
                            "recall_mean": float(fin.mean()),
                            "recall_min": float(fin.min()),
                            "exact_streams": n_exact}
    pass2_ms = traced_ms(torch, lambda: eng.update_pass2(*steps[1]),
                         "update_pass2, 1 call", tag)
    out["onepass_pass2"]["traced_ms"] = pass2_ms
    del eng, pe, frozen, plain2, samp, exact
    torch.cuda.empty_cache()
    log(f"[main] samplers phase launches on the main paths: {launches}")
    log(f"[phase] samplers: {time.perf_counter() - t_phase:.2f} s wall")
    return launches, out


def time_tv_shapes(torch, st, steps, tag) -> dict:
    """The scatter at the TV cascade's flush (B x r streams of one step) and
    the estimate at its refresh (B x r x (C + n) keys) and draw (B x C
    keys) shapes, each against its bound from these inputs, as phase 4
    counts them; the scatter with its index_add_ yardstick."""
    from repro_torch.core import transforms
    from repro_torch.kernels import countsketch_scatter as s

    dev = torch.device(DEVICE)
    Bt, r = st.transform_seeds.shape
    seeds = st.sketches.seed.reshape(-1)
    tseeds = st.transform_seeds.reshape(-1)
    keys = torch.from_numpy(steps[1][0]).to(dev).repeat_interleave(r, 0)
    vals = torch.from_numpy(steps[1][1]).to(dev).repeat_interleave(r, 0)
    before = dict(s.variant_launches)
    s.countsketch_scatter_batched(keys, vals, ROWS, WIDTH, seeds, p=P,
                                  transform_seeds=tseeds)
    if launched(s, before) != "smem":
        raise AssertionError("the TV cascade's scatter is not the "
                             "shared-memory variant")
    s_ms = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
        keys, vals, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds), 10)
    live = int((keys != -1).sum())
    s_bound, s_by = bound(keys.numel() * 8 + Bt * r * ROWS * WIDTH * 4,
                          live * SCATTER_OPS_PER_SLOT)
    tv_ = transforms.transform_values(keys, vals, P, tseeds[:, None])
    idx, sign = row_index(torch, keys, seeds, WIDTH)
    idx = idx.reshape(-1)
    sv = (sign * tv_.repeat(1, ROWS)).reshape(-1)
    del tv_, sign
    flat = torch.zeros(Bt * r * ROWS * WIDTH, device=dev)
    s_lib = cuda_ms(torch, lambda: flat.zero_().index_add_(0, idx, sv), 5)
    del idx, sv, flat
    torch.cuda.empty_cache()
    plan = plan_of(Bt * r, keys.shape[1], None)
    log(f"[time] scatter at the TV cascade's flush (B*r={Bt * r}, n="
        f"{keys.shape[1]}): kernel {s_ms:.4f} ms ({plan['blocks']} blocks, "
        f"one a stream: {plan['one_per_stream']}), index_add_ yardstick "
        f"(memory half only) {s_lib:.4f} ms, bound {s_bound:.4f} ms by "
        f"{s_by}, {100 * s_bound / s_ms:.1f} % of bound {tag}")
    tables = st.sketches.table.reshape(Bt * r, ROWS, WIDTH)
    cands = st.cand_keys.reshape(Bt * r, -1)
    qkeys = torch.cat([cands, keys], 1).contiguous()
    del keys, vals
    check_estimate(torch, "TV cascade refresh shape", tables, qkeys, seeds)
    refresh = time_estimate(torch, "TV cascade refresh shape", tables, qkeys,
                            seeds, 5, 1, tag)
    del qkeys
    torch.cuda.empty_cache()
    draw_tables = st.sketches.table[:, 0].contiguous()
    draw_keys = st.cand_keys[:, 0].contiguous()
    draw_seeds = st.sketches.seed[:, 0].contiguous()
    check_estimate(torch, "TV draw shape", draw_tables, draw_keys,
                   draw_seeds)
    draw = time_estimate(torch, "TV draw shape", draw_tables, draw_keys,
                         draw_seeds, 20, 3, tag)
    return {"scatter": {"ms": s_ms, "bound_ms": s_bound, "bound_by": s_by,
                        "library_ms": s_lib, "streams": Bt * r,
                        "n": int(steps[1][0].shape[1])},
            "estimate_refresh": refresh, "estimate_draw": draw}


# -- the deterministic flush path and the async and pipeline planes --------

# the pipeline's shards, its steps (each one flush; the host partition of a
# (4096, 5120) flush takes seconds), and the interval trigger's age bound
PIPE_SHARDS, PIPE_STEPS, INTERVAL_S = 4, 2, 0.5
TRACED_FLUSHES = 4  # the overlap's traced window


class deterministic_mode:
    """``torch.use_deterministic_algorithms(True)`` inside, the caller's
    setting restored after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        t = self.torch
        self.was = (t.are_deterministic_algorithms_enabled(),
                    t.is_deterministic_algorithms_warn_only_enabled())
        t.use_deterministic_algorithms(True)
        return self

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.was[0],
                                                warn_only=self.was[1])
        return False


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (a float -0 differs from +0, NaN payloads count)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = (x.contiguous().view(torch.int32) for x in (a, b))
    return bool(torch.equal(a, b))


def states_equal(torch, a, b) -> bool:
    from repro_torch.engine.engine import _leaves

    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(same_bits(torch, x, y)
                                      for x, y in zip(la, lb))


def samples_equal(torch, a, b) -> bool:
    return all(same_bits(torch, x, y) for x, y in zip(a, b))


def det_scatter_shape(torch, what, keys, vals, seeds, tseeds, iters, tag):
    """The det scatter at one shape: three launches give the same bits,
    each cell within its rounding bound of the plain version and of the
    shared-memory (atomics) variant; times of both variants, by CUDA
    events, beside the bound this run's inputs give."""
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref

    Bs, n = keys.shape
    kw = dict(p=P, transform_seeds=tseeds)
    want = ref.countsketch_scatter_batched_ref(keys, vals, ROWS, WIDTH,
                                               seeds, **kw)
    tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
        keys, vals, ROWS, WIDTH, seeds, **kw))
    outs = []
    with deterministic_mode(torch):
        for _ in range(3):
            before = dict(s.variant_launches)
            outs.append(s.countsketch_scatter_batched(keys, vals, ROWS,
                                                      WIDTH, seeds, **kw))
            ran = {v: s.variant_launches[v] - before[v] for v in before}
            if ran != {"smem": 0, "global": 0, "det": 1}:
                raise AssertionError(f"det scatter {what}: launched {ran}")
    torch.cuda.synchronize()
    identical = all(same_bits(torch, o, outs[0]) for o in outs[1:])
    log(f"[det] scatter {what} (B={Bs}, n={n}): 3 launches in the "
        f"deterministic mode, identical bits: {identical} {tag}")
    if not identical:
        raise AssertionError(f"det scatter {what}: launches differ")
    del outs[1:]
    err, ratio = check_sum(torch, f"scatter {what} [det]", outs[0], want,
                           tol)
    atomics = s.countsketch_scatter_batched(keys, vals, ROWS, WIDTH, seeds,
                                            _variant="smem", **kw)
    a_err, a_ratio = check_sum(torch, f"scatter {what} [det] vs [smem] "
                               f"(atomics)", outs[0], atomics, tol)
    del want, tol, atomics, outs
    torch.cuda.empty_cache()
    with deterministic_mode(torch):
        det_ms = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
            keys, vals, ROWS, WIDTH, seeds, **kw), iters)
    smem_ms = cuda_ms(torch, lambda: s.countsketch_scatter_batched(
        keys, vals, ROWS, WIDTH, seeds, _variant="smem", **kw), iters)
    live = int((keys != -1).sum())
    b_ms, b_by = bound(keys.numel() * 8 + Bs * ROWS * WIDTH * 4,
                       live * SCATTER_OPS_PER_SLOT)
    log(f"[time] scatter {what} (B={Bs}, n={n}): det {det_ms:.4f} ms "
        f"({100 * b_ms / det_ms:.1f} % of bound), shared-memory atomics "
        f"{smem_ms:.4f} ms ({100 * b_ms / smem_ms:.1f} %), bound "
        f"{b_ms:.4f} ms by {b_by}; det / atomics "
        f"{det_ms / smem_ms:.2f}x {tag}")
    return {"ms": det_ms, "atomics_ms": smem_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err,
            "worst_err_over_bound": ratio, "vs_atomics_max_abs_err": a_err,
            "vs_atomics_worst_err_over_bound": a_ratio}


def segment_sum_shape(torch, what, rows, tag):
    """The sorted segment sum at a ``_dedup_topc`` shape of the flush (rows
    x (C + n) entries, the run ids of sorted Zipf-like keys, made on the
    card): the same bits on two launches, and on the first ``SUB_B`` rows
    bit for bit the plain version on the CPU (index order); its time, the
    plain version's on the card under the mode (PyTorch's deterministic
    scatter_add_) and the atomics scatter_add_ (the mode off)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as sg

    n = CANDIDATES + INSERTS + int(INSERTS * DELETE_FRACTION)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    u = torch.rand((rows, n), generator=g, device=DEVICE)
    # a Zipf(1.2)-like head: key = floor(u^(-1/0.2)), key 1 in 13 % of a
    # row's slots
    keys = torch.sort(torch.clamp(u.pow(-1.0 / (ALPHA - 1.0)), max=VOCAB)
                      .to(torch.int64), 1).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    seg = torch.cumsum(first.to(torch.int64), 1) - 1
    vals = torch.randn((rows, n), generator=g, device=DEVICE)
    del u, keys, first
    got = [sg.segment_sum(vals, seg) for _ in range(2)]
    want = ref.segment_sum_ref(vals[:SUB_B].cpu(), seg[:SUB_B].cpu())
    ok = same_bits(torch, got[0], got[1]) \
        and same_bits(torch, got[0][:SUB_B].cpu(), want)
    log(f"[det] segment sum {what} ({rows} x {n}): 2 launches identical, "
        f"and the first {SUB_B} rows equal to the CPU's scatter_add_ bit for "
        f"bit: {ok} {tag}")
    if not ok:
        raise AssertionError(f"segment sum {what} is not deterministic or "
                             f"differs from the CPU's")
    del got, want
    k_ms = cuda_ms(torch, lambda: sg.segment_sum(vals, seg), 10)
    with deterministic_mode(torch):
        plain_ms = cuda_ms(torch, lambda: ref.segment_sum_ref(vals, seg),
                           3, warmup=1)
    lib_ms = cuda_ms(torch, lambda: ref.segment_sum_ref(vals, seg), 10)
    b_ms, b_by = bound(rows * n * 16, rows * n)
    log(f"[time] segment sum {what} ({rows} x {n}): kernel {k_ms:.4f} ms "
        f"({100 * b_ms / k_ms:.1f} % of bound {b_ms:.4f} ms by {b_by}); "
        f"PyTorch's deterministic scatter_add_ {plain_ms:.4f} ms; atomics "
        f"scatter_add_ (mode off) {lib_ms:.4f} ms {tag}")
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def nan_fill_ms(torch, streams, tag) -> dict:
    """The deterministic mode's cost of ``torch.empty`` for a scatter delta
    of ``streams`` tables (it fills new float memory with NaN)."""
    shape = (streams, ROWS, WIDTH)
    off = cuda_ms(torch, lambda: torch.empty(shape, device=DEVICE), 10)
    with deterministic_mode(torch):
        on = cuda_ms(torch, lambda: torch.empty(shape, device=DEVICE), 10)
    log(f"[time] torch.empty of a {streams * ROWS * WIDTH * 4 / 1e6:.0f} MB "
        f"scatter delta: {off:.4f} ms, in the deterministic mode (NaN "
        f"fill) {on:.4f} ms {tag}")
    return {"mb": streams * ROWS * WIDTH * 4 / 1e6, "ms": off, "det_ms": on}


def pytorch_sums_ms(torch, keys, vals, tag) -> dict:
    """The two PyTorch sums of the flush paths that keep PyTorch's own
    deterministic forms under the mode (the card tests check their bits):
    the perfect spec's ``scatter_add_`` (``SUB_B`` streams into a 2**20
    domain) and ``countsketch.update``'s ``index_add_`` (B x 7 x n terms,
    a plain path), each timed with the mode off and on."""
    from repro_torch.core import countsketch
    from repro_torch.core.sampler import SamplerConfig, make_sampler

    spec = make_sampler("perfect", SamplerConfig(domain=VOCAB))
    ids = torch.arange(B, device=DEVICE)
    st = spec.init(ids[:SUB_B], ids[:SUB_B])
    sk = countsketch.init(ROWS, WIDTH, ids)
    fns = {"perfect scatter_add_": lambda: spec.update(
               st, keys[:SUB_B], vals[:SUB_B]),
           "countsketch.update index_add_": lambda: countsketch.update(
               sk, keys, vals)}
    out = {}
    for what, fn in fns.items():
        off = cuda_ms(torch, fn, 3, warmup=1)
        with deterministic_mode(torch):
            on = cuda_ms(torch, fn, 3, warmup=1)
        out[what] = {"ms": off, "det_ms": on}
        log(f"[time] {what}: {off:.4f} ms, in the deterministic mode "
            f"{on:.4f} ms {tag}")
    return out


def plane_engine(name, plane, num_streams=None, policy=None, **opts):
    from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine

    return SketchEngine(
        EngineConfig(num_streams=num_streams or B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P, sampler=name,
                     domain=VOCAB),
        plane=plane, flush=policy or FlushPolicy(max_elems=4096),
        device=DEVICE, plane_opts=opts or None)


def drive_plane(torch, eng, steps, n=None):
    """Ingest the steps (each fills one flush) and drain; the seconds to the
    card's synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for keys, vals in steps:
        eng.ingest(keys[:n], vals[:n])
    eng.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def async_vs_sparse(torch, name, steps, k, n, tag):
    """Sampler ``name`` on the sparse and the async plane in the
    deterministic mode, on the first ``n`` streams: every state leaf and
    the sample equal bit for bit.  Returns the async run's launches."""
    engs, counts = {}, {}
    with deterministic_mode(torch):
        for plane in ("sparse", "async"):
            eng = plane_engine(name, plane, num_streams=n)
            reset_counts()
            drive_plane(torch, eng, steps, n)
            counts[plane] = read_counts()
            engs[plane] = eng
        state_ok = states_equal(torch, engs["sparse"].state,
                                engs["async"].state)
        samp_ok = samples_equal(torch, engs["sparse"].sample(k),
                                engs["async"].sample(k))
    engs["async"].plane.close()
    log(f"[det] {name} (B={n}, {len(steps)} flushes): async vs sparse, every "
        f"state leaf bit for bit: {state_ok}; sample(k={k}) bit for bit: "
        f"{samp_ok}; launches sparse {counts['sparse']}, async "
        f"{counts['async']} {tag}")
    if not (state_ok and samp_ok) or counts["sparse"] != counts["async"]:
        raise AssertionError(f"{name}: async differs from sparse in the "
                             f"deterministic mode")
    return counts["async"]


def profiler_config(torch):
    """An experimental config that records every thread's ranges (the async
    worker's ``plane.h2d``/``plane.dispatch``), where this PyTorch has it."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def overlap(torch, plane, steps, tag) -> dict:
    """Default mode (atomics): the ingest rate of the steps (one flush
    each), then a trace of ``TRACED_FLUSHES`` flushes and the drain, its
    busy share and plane ranges."""
    from torch.profiler import ProfilerActivity, profile

    eng = plane_engine("onepass", plane)
    secs = drive_plane(torch, eng, steps)
    events = sum(kk.size for kk, _ in steps)
    cfg = profiler_config(torch)
    eng2 = plane_engine("onepass", plane)
    eng2.ingest(*steps[0])
    eng2.flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **({"experimental_config": cfg} if cfg else {})) as prof:
        t0 = time.perf_counter()
        for keys, vals in steps[1:1 + TRACED_FLUSHES]:
            eng2.ingest(keys, vals)
        eng2.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"[overlap] {plane} plane: {events} events in {secs:.4f} s = "
        f"{events / secs:.4e} events/s ({len(steps)} flushes, default mode); "
        f"trace of "
        f"{TRACED_FLUSHES} flushes + drain, every thread's ranges: "
        f"{cfg is not None} {tag}")
    rows = trace_report(prof, RANGES, wall_ms,
                        f"{plane} plane, {TRACED_FLUSHES} flushes", tag,
                        top=6)
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    for e in (eng, eng2):
        e.plane.close()
    return {"events_per_s": events / secs, "seconds": secs,
            "traced_wall_ms": wall_ms, "busy_ms": busy,
            "busy_share": busy / wall_ms if rows else None}


def compare_histories(torch, what, st, ss, tol, seeds) -> int:
    """Two one-pass states of the same stream fed with other flush
    boundaries or shards: tables within the bounds, and sample keys
    identical but for near ties, non-finite streams and candidate buffers
    that differ; read over the union of both buffers, identical but for
    near ties and non-finite streams.  Returns the streams whose samples
    differ only through their buffers' histories.

    The candidate buffer is a heuristic whose content depends on the order
    of its refreshes (each flush refreshes among its own keys; a collapse
    among the shards' buffers), so a stream's samples may differ where a
    key of one sample is missing from the other state's buffer; read over
    the union of both buffers, the two tables must give the same sample
    but for near ties."""
    from repro_torch.engine.engine import onepass_sample_batched

    bad = compare_tables(torch, what, st.sketch.table, ss.sketch.table, tol)
    samp, ssamp = (onepass_sample_batched(x, K, P) for x in (st, ss))
    diff_a = ~(samp.keys[:, :, None] == ssamp.keys[:, None, :]).any(2)
    diff_b = ~(ssamp.keys[:, :, None] == samp.keys[:, None, :]).any(2)
    missing = ((diff_a & ~(samp.keys[:, :, None]
                           == ss.cand_keys[:, None, :]).any(2)).any(1)
               | (diff_b & ~(ssamp.keys[:, :, None]
                             == st.cand_keys[:, None, :]).any(2)).any(1))
    compare_samples(torch, what, samp, ss, tol, seeds, K, P, bad,
                    excused=missing,
                    excuse="a sampled key missing from the other state's "
                           "candidate buffer")
    pool = torch.sort(torch.cat([st.cand_keys, ss.cand_keys], 1), 1).values
    dup = torch.zeros_like(pool, dtype=torch.bool)
    dup[:, 1:] = pool[:, 1:] == pool[:, :-1]
    pool = torch.where(dup, -1, pool)
    compare_samples(torch, f"{what}, both read over the union of their "
                    f"candidate buffers",
                    onepass_sample_batched(st._replace(cand_keys=pool), K, P),
                    ss._replace(cand_keys=pool), tol, seeds, K, P, bad)
    return int(missing.sum())


def flush_plain(torch, steps, seeds, tseeds):
    """The plain scatter's table of ``steps`` (each (B, n) keys and values,
    numpy) summed into one table, and the per-cell rounding bound of such a
    sum, any order."""
    import numpy as np

    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    want = cnt = mass = None
    for keys, vals in steps:
        k = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
        t = ref.countsketch_scatter_batched_ref(k, v, ROWS, WIDTH, seeds, p=P,
                                                transform_seeds=tseeds)
        c, m = ref.countsketch_scatter_mass_ref(k, v, ROWS, WIDTH, seeds, p=P,
                                                transform_seeds=tseeds)
        if want is None:
            want, cnt, mass = t, c, m
        else:
            want += t
            cnt += c
            mass += m
        del k, v, t, c, m
    return want, ref.scatter_tolerance(cnt, mass)


def pipeline_checks(torch, steps, seeds, tseeds, tag) -> dict:
    """``shards=4`` at B streams: the sparse plane against the plain
    scatter and the collapse against the sparse plane within the summing
    tolerances, sample keys identical but for near ties
    and for candidate buffers that differ, and identical but for near ties
    when both are read over the union of the two buffers; async sub-planes
    against sparse sub-planes bit for bit in the deterministic mode (fed the
    same partition through ``ingest_shard``)."""
    from repro_torch.engine import planes

    psteps = steps[:PIPE_STEPS]
    sparse = plane_engine("onepass", "sparse")
    drive_plane(torch, sparse, psteps)
    pipe = plane_engine("onepass", "pipeline", shards=PIPE_SHARDS)
    reset_counts()
    secs = drive_plane(torch, pipe, psteps)
    st = pipe.state
    merged = read_counts()
    want, tol = flush_plain(torch, psteps, seeds, tseeds)
    ss = sparse.state
    compare_tables(torch, "sparse plane vs the plain scatter",
                   ss.sketch.table, want, tol)
    del want
    missing = compare_histories(torch, f"pipeline (shards={PIPE_SHARDS}) vs "
                                f"sparse", st, ss, tol, seeds)
    out = {"seconds": secs, "history_streams": missing}
    del tol, sparse, pipe, st, ss
    torch.cuda.empty_cache()
    parts = [planes.partition_by_key(keys, vals, PIPE_SHARDS)
             for keys, vals in psteps]
    engs = {}
    with deterministic_mode(torch):
        for sub in ("sparse", "async"):
            eng = plane_engine("onepass", "pipeline", shards=PIPE_SHARDS,
                               subplane=sub)
            for blocks in parts:
                for shard, (k, v) in enumerate(blocks):
                    eng.plane.ingest_shard(shard, k, v)
            eng.flush()
            engs[sub] = eng
        ok = states_equal(torch, engs["sparse"].state, engs["async"].state) \
            and samples_equal(torch, engs["sparse"].sample(K),
                              engs["async"].sample(K))
    engs["async"].plane.close()
    log(f"[det] pipeline (shards={PIPE_SHARDS}, B={B}, {PIPE_STEPS} "
        f"flushes): async sub-planes vs sparse sub-planes, merged state and "
        f"sample bit for bit: {ok}; collapse launches {merged} {tag}")
    if not ok:
        raise AssertionError("pipeline: async sub-planes differ from sparse "
                             "sub-planes")
    out["launches"] = merged
    return out


def interval_check(torch, steps, tag) -> dict:
    """A stalled producer: one microbatch under every ingest-time trigger,
    then no call but reads of ``plane.state`` (which settles in-flight work
    and does not flush).  The timer must submit it once it is
    ``INTERVAL_S`` old, and the state must then equal a sparse plane's
    flush of the same batch bit for bit (deterministic mode)."""
    from repro_torch.engine import FlushPolicy

    keys, vals = steps[0][0][:SUB_B, :1024], steps[0][1][:SUB_B, :1024]
    with deterministic_mode(torch):
        eng = plane_engine("onepass", "async", num_streams=SUB_B,
                           policy=FlushPolicy(max_elems=None,
                                              max_interval=INTERVAL_S))
        t0 = time.perf_counter()
        eng.ingest(keys, vals)
        published = None
        while time.perf_counter() - t0 < INTERVAL_S + 30.0:
            if bool(eng.plane.state.sketch.table.any()):
                published = time.perf_counter() - t0
                break
            time.sleep(0.01)
        pending = eng.pending
        ref_eng = plane_engine("onepass", "sparse", num_streams=SUB_B)
        ref_eng.ingest(keys, vals)
        ref_eng.flush()
        ok = published is not None and pending == 0 \
            and states_equal(torch, eng.plane.state, ref_eng.state)
    eng.plane.close()
    log(f"[det] interval trigger (max_interval {INTERVAL_S} s, no drain): "
        f"published after "
        f"{'never' if published is None else f'{published:.3f} s'}, pending "
        f"{pending}, state equal to the sparse plane's flush bit for bit: "
        f"{ok} {tag}")
    if not ok or published < INTERVAL_S:
        raise AssertionError("the interval timer did not publish the stalled "
                             "tail as it should")
    return {"max_interval_s": INTERVAL_S, "published_s": published}


def phase_determinism(torch, steps, tag):
    """The deterministic flush path and the async and pipeline planes at the
    sparse plane's deployment.  Returns the launches of the det scatter and
    the segment sum on the deterministic main path, and the records of the
    kernels line and the ``[planes]`` line."""
    from repro_torch.engine import derive_stream_seeds, engine_spec
    from repro_torch.engine.engine import EngineConfig

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out = {}
    cfg = EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                       candidates=CANDIDATES, p=P)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)

    # -- 1. the det scatter at the flush and the TV cascade shapes --------
    keys = torch.from_numpy(steps[1][0]).to(dev)
    vals = torch.from_numpy(steps[1][1]).to(dev)
    out["scatter_flush"] = det_scatter_shape(torch, "flush shape", keys,
                                             vals, seeds, tseeds, 20, tag)
    tv = engine_spec(cfg._replace(sampler="tv")).init(
        *derive_stream_seeds(cfg, device=dev))
    r = tv.transform_seeds.shape[1]
    tv_seeds = tv.sketches.seed.reshape(-1).clone()
    tv_tseeds = tv.transform_seeds.reshape(-1).clone()
    del tv
    torch.cuda.empty_cache()
    out["scatter_tv"] = det_scatter_shape(
        torch, "TV cascade shape", keys.repeat_interleave(r, 0),
        vals.repeat_interleave(r, 0), tv_seeds, tv_tseeds, 5, tag)
    del keys, vals, tv_seeds, tv_tseeds
    torch.cuda.empty_cache()
    out["segment_sum_flush"] = segment_sum_shape(torch, "flush shape", B,
                                                 tag)
    out["segment_sum_tv"] = segment_sum_shape(torch, "TV cascade shape",
                                              B * r, tag)
    out["nan_fill"] = [nan_fill_ms(torch, b, tag) for b in (B, B * r)]
    out["pytorch_sums"] = pytorch_sums_ms(
        torch, torch.from_numpy(steps[1][0]).to(dev),
        torch.from_numpy(steps[1][1]).to(dev), tag)
    torch.cuda.empty_cache()

    # -- 2. async against sparse, bit for bit, in the deterministic mode --
    launches = async_vs_sparse(torch, "onepass", steps, K, B, tag)
    flushes = len(steps)
    want = {"scatter": flushes, "smem": 0, "global": 0, "det": flushes,
            "estimate": flushes, "row_read": 0, "other": 0}
    got = {k: launches[k] for k in want}
    if got != want or launches["segment_sum"] < flushes:
        raise AssertionError(f"deterministic onepass path launches "
                             f"{launches}, expected {want} and a segment "
                             f"sum a flush")
    out["det_path_launches"] = launches
    for name, k in (("twopass", K), ("tv", TV_K), ("perfect", K)):
        async_vs_sparse(torch, name, steps, k, SUB_B, tag)
        torch.cuda.empty_cache()

    # -- 3. the overlap, measured in the default mode ---------------------
    out["overlap"] = {plane: overlap(torch, plane, steps, tag)
                      for plane in ("sparse", "async")}
    a, s = out["overlap"]["async"], out["overlap"]["sparse"]
    log(f"[overlap] async / sparse ingest rate "
        f"{a['events_per_s'] / s['events_per_s']:.3f} (one call, measured, "
        f"not claimed) {tag}")
    torch.cuda.empty_cache()

    # -- 4. the pipeline; 5. the interval timer ---------------------------
    out["pipeline"] = pipeline_checks(torch, steps, seeds, tseeds, tag)
    torch.cuda.empty_cache()
    out["interval"] = interval_check(torch, steps, tag)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[det] phase launches by variant on the deterministic onepass "
        f"path: det scatter {launches['det']}, shared-memory {launches['smem']}"
        f", global {launches['global']}, estimate {launches['estimate']}, "
        f"segment sum {launches['segment_sum']}")
    log(f"[phase] determinism, async and pipeline planes: "
        f"{out['wall_s']:.2f} s wall")
    return launches, out


# the conformance grid at the nightly operating point (``python -m
# repro_torch.validate --deep``): 384 trials, 3 x 384 oracle trials, every
# p, scheme, sampler and plane, and Table 3 at 12 randomizations
VALIDATE_TRIALS, VALIDATE_TABLE3_TRIALS = 384, 12
# the feeder: S producer shards, block_elems (the span), ring depth
FEED_SHARDS, FEED_BLOCK, FEED_PREFETCH = 4, 4096, 2


def uniform01_edge_pairs(torch, trials, seed, offset, n) -> int:
    """(trial, key) pairs of a trial seed bank whose ``uniform01`` is
    exactly 1.0 (the reference's fault, ROADMAP Queue 3), keys [0, n)."""
    from repro_torch.core import hashing
    from repro_torch.validate import empirics

    _, tseeds = empirics.derive_trial_seeds(trials, seed, offset,
                                            device=DEVICE)
    keys = torch.arange(n, dtype=torch.int64, device=tseeds.device)
    return int((hashing.uniform01(keys[None, :], tseeds[:, None])
                == 1.0).sum())


def phase_validate(torch, tag):
    """The conformance grid (``conformance.run_suite``'s, cell by cell
    through ``run_cell``, then ``check_table3_nrmse``) at the ``--deep``
    operating point on the card: one ``conformance_check`` line per check
    and the summary line, wall time by path and by sampler, launches by
    path, and the live threads after the grid.  Fails unless no check fails
    and every cell passes at least one.  Then a deterministic-mode cell:
    the async path's trials equal the ingest path's bit for bit.  Returns
    the grid's launches (summed over paths and Table 3) and the record of
    the ``[validate]`` line."""
    import threading

    from repro_torch.validate import conformance as C
    from repro_torch.validate import empirics
    from repro_torch.validate.__main__ import check_lines
    from repro_torch.validate.report import FAIL, PASS, build, summary_line

    t_phase = time.perf_counter()
    cfg = C.ConformanceConfig(trials=VALIDATE_TRIALS,
                              ref_trials=3 * VALIDATE_TRIALS, device=DEVICE)
    threads_before = threading.active_count()
    by_path, by_sampler, launches, cells = {}, {}, {}, {}
    samplers = list(C.available())
    results = []
    reset_counts()
    t0 = time.perf_counter()
    # run_suite's grid, one cell at a time, each timed and its launches read
    for name in samplers:
        for scheme in C.SCHEMES:
            for p in C.PS:
                for path in empirics.PATHS:
                    before = read_counts()
                    t1 = time.perf_counter()
                    cell = C.run_cell(name, scheme, p, path, cfg)
                    secs = time.perf_counter() - t1
                    got = since(before)
                    acc = launches.setdefault(path, dict.fromkeys(got, 0))
                    for key in got:
                        acc[key] += got[key]
                    by_path[path] = by_path.get(path, 0.0) + secs
                    by_sampler[name] = by_sampler.get(name, 0.0) + secs
                    cells[(name, scheme, p, path)] = [r.status for r in cell]
                    results.extend(cell)
    before = read_counts()
    results.extend(C.check_table3_nrmse(trials=VALIDATE_TABLE3_TRIALS,
                                        delta=cfg.delta, device=cfg.device))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches["table3"] = since(before)
    threads_after = threading.active_count()
    rep = build(results, {"suite": "repro_torch.validate",
                          "config": cfg._asdict(), "samplers": samplers,
                          "schemes": list(C.SCHEMES), "ps": list(C.PS),
                          "paths": list(empirics.PATHS),
                          "table3_trials": VALIDATE_TABLE3_TRIALS})
    for line in check_lines(rep):
        log(line)
    log(summary_line(rep))
    grid_s = sum(by_path.values())
    log(f"[validate] grid of {len(cells)} cells ({VALIDATE_TRIALS} trials, "
        f"{3 * VALIDATE_TRIALS} oracle trials) {grid_s:.2f} s, Table 3 "
        f"({VALIDATE_TABLE3_TRIALS} trials) {total_s - grid_s:.2f} s wall "
        f"{tag}")
    for what, secs in [*(("path " + k, v) for k, v in by_path.items()),
                       *(("sampler " + k, v) for k, v in by_sampler.items())]:
        log(f"[validate] {what}: {secs:.2f} s wall {tag}")
    for path, got in launches.items():
        log(f"[validate] launches on {path}: {got}")
    log(f"[validate] live threads: {threads_before} before the grid, "
        f"{threads_after} after")
    edge = {"table3": uniform01_edge_pairs(torch, VALIDATE_TABLE3_TRIALS,
                                           0x7AB3, 0, 10_000),
            "grid": sum(uniform01_edge_pairs(torch, t, cfg.seed, off, cfg.n)
                        for t, off in ((cfg.trials, 0),
                                       (cfg.ref_trials, cfg.ref_offset),
                                       (cfg.trials, 2 * cfg.ref_offset)))}
    log(f"[validate] (trial, key) pairs at the uniform01 == 1.0 edge under "
        f"the ppswor/priority transform seeds: Table 3 {edge['table3']} of "
        f"{VALIDATE_TABLE3_TRIALS * 10_000}, grid {edge['grid']} of "
        f"{(2 * cfg.trials + cfg.ref_trials) * cfg.n}")
    s = rep["summary"]
    no_pass = [c for c, st in cells.items() if PASS not in st]
    if s["failed"] or no_pass:
        for r in rep["results"]:
            if r["status"] == FAIL:
                log(f"[validate] FAIL {r['check']} {r['sampler']} "
                    f"{r['scheme']} p={r['p']:g} {r['path']}: "
                    f"{json.dumps(r['details'])}")
        raise AssertionError(f"conformance grid: {s['failed']} failed "
                             f"checks, cells without a pass: {no_pass}")
    for path in ("ingest", "async", "pipeline"):
        got = launches[path]
        if got["scatter"] <= 0 or got["smem"] <= 0 or got["estimate"] <= 0:
            raise AssertionError(f"conformance grid: the {path} path "
                                 f"launched {got}")
    if threads_after > threads_before:
        raise AssertionError(f"conformance grid: {threads_after} threads "
                             f"live after it, {threads_before} before")

    # -- the async path against the ingest path, bit for bit --------------
    freqs = empirics.zipf_freqs(64, 2.0, seed=3)
    spec = empirics.spec_for("onepass", 64, 4, 1.0, "ppswor")
    with deterministic_mode(torch):
        reset_counts()
        runs = {path: empirics.run_trials(spec, freqs, 4, 16, seed=5,
                                          path=path, device=DEVICE)
                for path in ("ingest", "async")}
        det = read_counts()
        ok = states_equal(torch, runs["ingest"][1], runs["async"][1]) \
            and samples_equal(torch, runs["ingest"][0], runs["async"][0])
    log(f"[validate] deterministic mode, onepass trials (n = 64, k = 4, 16 "
        f"trials, 3 chunks): async vs ingest, every state leaf and the "
        f"sample bit for bit: {ok}; launches {det} {tag}")
    if not ok or det["det"] != 2 * cfg.chunks:
        raise AssertionError("validate: the async path's trials differ from "
                             "the ingest path's in the deterministic mode")
    total = dict.fromkeys(read_counts(), 0)
    for got in launches.values():
        for key in total:
            total[key] += got[key]
    for key in total:
        total[key] += det[key]
    out = {"wall_s": time.perf_counter() - t_phase, "grid_s": grid_s,
           "table3_s": total_s - grid_s, "by_path_s": by_path,
           "by_sampler_s": by_sampler, "launches": launches,
           "summary": s, "threads": [threads_before, threads_after],
           "uniform01_edge_pairs": edge, "det_cell_launches": det}
    log(f"[phase] validate: {out['wall_s']:.2f} s wall")
    return total, out


def phase_ingest(torch, seed, tag):
    """The feeder at the sparse plane's deployment: one canonical
    ``TurnstileZipfStream(2**20, alpha=1.2, delete_fraction=0.25)`` of
    STEPS x (4096 inserts + 1024 retractions), split over FEED_SHARDS
    producer shards, packed into (B, 4096) blocks broadcast to B = 4096
    streams.  Fan-in into ``sparse`` and ``async``, per-shard into
    ``pipeline``, each against the sparse plane's direct ingest of the same
    ragged stream (one flush a step), whose table is held to the plain
    scatter's: tables within the summing bounds,
    samples as ``compare_histories`` holds them; fan-in ``async`` equal to
    fan-in ``sparse`` bit for bit in the deterministic mode.  Prints
    events/s, ``pack_efficiency``, the producers' and the pump's wait and
    the busy share of a traced fan-in.  Returns the launches of its
    default-mode runs and of its deterministic runs, and the record of the
    ``[ingest]`` line."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.ingest_pipeline import (PrefetchingFeeder,
                                                  ShardedSource)
    from repro_torch.data.pipeline import TurnstileZipfStream
    from repro_torch.engine import EngineConfig, derive_stream_seeds

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    stream = TurnstileZipfStream(vocab_size=VOCAB, alpha=ALPHA, seed=seed,
                                 delete_fraction=DELETE_FRACTION)
    evs = [stream.events_at(t, INSERTS) for t in range(STEPS)]
    events = sum(k.size for k, _ in evs)
    steps = [(np.broadcast_to(k[None], (B, k.size)),
              np.broadcast_to(v[None], (B, v.size))) for k, v in evs]
    seeds, tseeds = derive_stream_seeds(
        EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                     candidates=CANDIDATES, p=P), device=dev)
    out = {"events": events, "streams": B, "shards": FEED_SHARDS}

    def feed(plane, pershard=False, **opts):
        eng = plane_engine("onepass", plane, **opts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = PrefetchingFeeder(ShardedSource(evs, FEED_SHARDS), eng,
                                  block_elems=FEED_BLOCK,
                                  prefetch=FEED_PREFETCH,
                                  pershard=pershard).run()
        st = eng.state  # the pipeline's collapse
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = {"seconds": secs, "events_per_s": events * B / secs,
               "blocks": stats.blocks, "span": stats.span,
               "pack_efficiency": stats.pack_efficiency,
               "producer_wait_s": stats.producer_wait_s,
               "pump_wait_s": stats.pump_wait_s}
        log(f"[ingest] {'per-shard' if pershard else 'fan-in'} -> {plane}: "
            f"{events} events x {B} streams in {secs:.4f} s = "
            f"{rec['events_per_s']:.4e} events/s; {stats.blocks} blocks of "
            f"{stats.span}, pack_efficiency {stats.pack_efficiency:.4f}, "
            f"producers' wait {stats.producer_wait_s:.4f} s, pump's wait "
            f"{stats.pump_wait_s:.4f} s {tag}")
        return eng, st, rec

    # -- the reference: the sparse plane's direct ingest, one flush a step
    direct = plane_engine("onepass", "sparse")
    reset_counts()
    secs = drive_plane(torch, direct, steps)
    out["direct"] = {"seconds": secs, "events_per_s": events * B / secs,
                     "launches": read_counts()}
    log(f"[ingest] direct ingest -> sparse: {events} events x {B} streams in "
        f"{secs:.4f} s = {events * B / secs:.4e} events/s ({STEPS} flushes) "
        f"{tag}")
    ss = direct.state
    want, tol = flush_plain(torch, steps, seeds, tseeds)
    compare_tables(torch, "direct ingest -> sparse vs the plain scatter",
                   ss.sketch.table, want, tol)
    del want

    # -- fan-in into sparse and async, per-shard into pipeline ------------
    reset_counts()
    launches = {}
    for plane, pershard, opts in (("sparse", False, {}),
                                  ("async", False, {}),
                                  ("pipeline", True,
                                   {"shards": FEED_SHARDS})):
        before = read_counts()
        eng, st, rec = feed(plane, pershard, **opts)
        rec["launches"] = launches[plane] = since(before)
        what = (f"{'per-shard' if pershard else 'fan-in'} -> {plane} vs "
                f"direct ingest")
        rec["history_streams"] = compare_histories(torch, what, st, ss, tol,
                                                   seeds)
        if rec["launches"]["scatter"] < rec["blocks"] \
                or rec["launches"]["estimate"] < rec["blocks"]:
            raise AssertionError(f"{what}: launches {rec['launches']} for "
                                 f"{rec['blocks']} blocks")
        out[f"{'pershard' if pershard else 'fanin'}_{plane}"] = rec
        eng.plane.close()
        del eng, st
        torch.cuda.empty_cache()
    launches["direct"] = out["direct"]["launches"]
    main_launches = {key: sum(got[key] for got in launches.values())
                     for key in launches["direct"]}
    log(f"[ingest] launches: {launches}")
    for plane in ("async", "pipeline"):
        key = ("pershard_" if plane == "pipeline" else "fanin_") + plane
        log(f"[ingest] {key} / fanin_sparse events/s "
            f"{out[key]['events_per_s'] / out['fanin_sparse']['events_per_s']:.3f}"
            f"; fanin_sparse / direct "
            f"{out['fanin_sparse']['events_per_s'] / out['direct']['events_per_s']:.3f}"
            f" (one call, measured, not claimed) {tag}")
    del tol, ss, direct
    torch.cuda.empty_cache()

    # -- a traced fan-in into the sparse plane: every thread's ranges -----
    cfg = profiler_config(torch)
    eng = plane_engine("onepass", "sparse")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **({"experimental_config": cfg} if cfg else {})) as prof:
        t0 = time.perf_counter()
        PrefetchingFeeder(ShardedSource(evs, FEED_SHARDS), eng,
                          block_elems=FEED_BLOCK,
                          prefetch=FEED_PREFETCH).run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = trace_report(prof, RANGES, wall_ms, "fan-in -> sparse, whole feed",
                        tag, top=6)
    busy = sum(r[0] for r in rows if "Activity Buffer" not in r[2])
    out["traced"] = {"wall_ms": wall_ms, "busy_ms": busy,
                     "busy_share": busy / wall_ms if rows else None}
    del eng, prof
    torch.cuda.empty_cache()

    # -- fan-in async against fan-in sparse, bit for bit, deterministic ---
    engs = {}
    with deterministic_mode(torch):
        reset_counts()
        for plane in ("sparse", "async"):
            engs[plane] = plane_engine("onepass", plane)
            PrefetchingFeeder(ShardedSource(evs, FEED_SHARDS), engs[plane],
                              block_elems=FEED_BLOCK,
                              prefetch=FEED_PREFETCH).run()
        det = read_counts()
        ok = states_equal(torch, engs["sparse"].state, engs["async"].state) \
            and samples_equal(torch, engs["sparse"].sample(K),
                              engs["async"].sample(K))
    engs["async"].plane.close()
    log(f"[det] fan-in (B={B}, {FEED_SHARDS} shards): async vs sparse, every "
        f"state leaf and sample(k={K}) bit for bit: {ok}; launches {det} "
        f"{tag}")
    if not ok or det["det"] != det["scatter"] or det["det"] == 0:
        raise AssertionError("fan-in: async differs from sparse in the "
                             "deterministic mode")
    out["det_launches"] = det
    del engs
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase] ingest pipeline: {out['wall_s']:.2f} s wall")
    return main_launches, det, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated streams and gradients")
    ap.add_argument("--sass", action="store_true",
                    help="only count the transform factor's SASS, old and "
                         "new, and exit")
    args = ap.parse_args()
    if args.sass:
        return factor_sass()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.engine import derive_stream_seeds
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # -- phase 1: the card and the build --------------------------------
    t_phase = time.perf_counter()
    smi = card_info()
    tag = f"[{smi}]"
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(smi)
    log(f"[card] {kind} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda} {tag}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
        f"wall (" + ", ".join(f"{b.name} {b.seconds:.2f} s"
                              for b in built.values()) + ")")
    for b in built.values():
        for line in b.log.splitlines():
            if line.strip():
                log(f"[build] {b.name}: {line.strip()}")
    report_occupancy(tag)
    log(f"[phase] 1 card and build: {time.perf_counter() - t_phase:.2f} s "
        f"wall")

    # -- phases 2-4: the sparse plane -------------------------------------
    cfg = EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                       candidates=CANDIDATES, p=P)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)
    (stream, steps), kernels, errs = phase_sparse(torch, args, seeds, tseeds,
                                                  tag)
    del seeds, tseeds
    torch.cuda.empty_cache()

    # -- phase 5: dense segments; phase 6: single-stream entry points -----
    entry, wg_values, dense_estimates, dense_est = phase_dense(torch, args,
                                                               tag)
    kernels.append(entry)
    single = phase_single(torch, wg_values, tag)
    kernels.extend(single)
    torch.cuda.empty_cache()

    # -- the samplers phase: twopass, tv, onepass pass II, perfect -------
    sampler_launches, samplers = phase_samplers(torch, steps, stream, tag)
    torch.cuda.empty_cache()

    # -- the deterministic flush path, the async and pipeline planes ------
    det_launches, planes = phase_determinism(torch, steps, tag)
    del steps, stream
    torch.cuda.empty_cache()

    # -- the conformance grid; the ingest pipeline -------------------------
    validate_launches, validate = phase_validate(torch, tag)
    torch.cuda.empty_cache()
    ingest_launches, ingest_det, ingest = phase_ingest(torch, args.seed, tag)

    # -- phase 7: the kernels line and the ok line -------------------------
    by_name = {k["name"]: k for k in kernels}
    est = by_name["countsketch_estimate_batched"]
    est["launches"] += dense_estimates
    est["dense_shape"] = {
        "ms": dense_est["estimate"], "plain_ms": dense_est["plain"],
        "bound_ms": dense_est["bound"], "bound_by": dense_est["bound_by"],
        "library_ms": dense_est["library"],
        "row_read_median_ms": dense_est["row_read_median"],
        "row_read_ms": dense_est["row_read"]}
    log(f"[main] estimate launches on the dense path: {dense_estimates}; "
        f"worst err/bound of the update at its edge shapes "
        f"{errs['update_edge_ratio']:.3e}")
    scatter = by_name["countsketch_scatter_batched"]
    scatter["launches"] += sampler_launches["scatter"]
    scatter["variants"]["smem"]["launches"] += sampler_launches["smem"]
    scatter["tv_cascade_shape"] = samplers["tv_shapes"]["scatter"]
    est["launches"] += sampler_launches["estimate"]
    for key in ("refresh", "draw"):
        t = samplers["tv_shapes"][f"estimate_{key}"]
        est[f"tv_{key}_shape"] = {
            "ms": t["estimate"], "plain_ms": t["plain"],
            "bound_ms": t["bound"], "bound_by": t["bound_by"],
            "library_ms": t["library"],
            "row_read_median_ms": t["row_read_median"],
            "row_read_ms": t["row_read"]}
    scatter["launches"] += det_launches["scatter"]
    est["launches"] += det_launches["estimate"]
    sf, stv = planes["scatter_flush"], planes["scatter_tv"]
    scatter["variants"]["det"] = {
        "launches": det_launches["det"],
        "max_abs_err": sf["max_abs_err"],
        "worst_err_over_bound": max(sf["worst_err_over_bound"],
                                    stv["worst_err_over_bound"]),
        "vs_atomics_worst_err_over_bound": max(
            sf["vs_atomics_worst_err_over_bound"],
            stv["vs_atomics_worst_err_over_bound"]),
        "ms": sf["ms"], "bound_ms": sf["bound_ms"],
        "bound_by": sf["bound_by"], "atomics_ms": sf["atomics_ms"],
        "plan": plan_of(B, INSERTS + int(INSERTS * DELETE_FRACTION), None,
                        variant="det"),
        "occupancy": OCCUPANCY.get(("countsketch_scatter", "det")),
        "tv_cascade_shape": {k: stv[k] for k in ("ms", "atomics_ms",
                                                 "bound_ms", "bound_by")}}
    # the conformance grid's and the feeder's launches (the grid's and the
    # feeder's default-mode runs take the shared-memory variant; their
    # deterministic cells the det variant and the segment sum)
    for got in (validate_launches, ingest_launches, ingest_det):
        scatter["launches"] += got["scatter"]
        scatter["variants"]["smem"]["launches"] += got["smem"]
        scatter["variants"]["det"]["launches"] += got["det"]
        est["launches"] += got["estimate"]
    scatter["validate_launches"] = {
        k: validate_launches[k] for k in ("scatter", "smem", "det")}
    scatter["ingest_launches"] = {
        k: ingest_launches[k] + ingest_det[k]
        for k in ("scatter", "smem", "det")}
    est["validate_launches"] = validate_launches["estimate"]
    est["ingest_launches"] = (ingest_launches["estimate"]
                              + ingest_det["estimate"])
    ssf, sstv = planes["segment_sum_flush"], planes["segment_sum_tv"]
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/core/worp.py:70 (jax.ops.segment_sum in XLA, "
                    "no pallas_call; the deterministic mode's form of "
                    "scatter_add_)",
        "launches": (det_launches["segment_sum"]
                     + validate_launches["segment_sum"]
                     + ingest_det["segment_sum"]),
        "max_abs_err": 0.0,
        "parity": "bit for bit equal to the CPU's scatter_add_ (index "
                  "order), the same bits on every launch",
        "ms": ssf["ms"], "plain_ms": ssf["plain_ms"],
        "bound_ms": ssf["bound_ms"], "bound_by": ssf["bound_by"],
        "library_ms": ssf["library_ms"],
        "plain": "PyTorch's deterministic scatter_add_ (the mode on)",
        "library": "scatter_add_ with atomics (the mode off)",
        "occupancy": OCCUPANCY.get(("segment_sum", "")),
        "tv_cascade_shape": sstv})
    log("[samplers] " + json.dumps({k: v for k, v in samplers.items()
                                    if k != "tv_shapes"}))
    log("[planes] " + json.dumps({k: v for k, v in planes.items()
                                  if k not in ("scatter_flush", "scatter_tv",
                                               "segment_sum_flush",
                                               "segment_sum_tv")}))
    log("[validate] " + json.dumps(
        {k: v for k, v in validate.items() if k != "launches"}))
    log("[ingest] " + json.dumps(ingest))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
