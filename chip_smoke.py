#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Three paths, each driven with the kernels' launch counts set to 0 just
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
     stream, and a table too large for shared memory; the estimate at the
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
    ok = bool(same[~fin].all()) and bool((err <= tol).all())
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
             tiling.THREADS_PER_BLOCK, 0)):
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


def plan_of(B, n, lengths, rows=ROWS, width=WIDTH):
    """The shared-memory plan the wrappers launch for these shapes."""
    from repro_torch.kernels import tiling

    p = tiling.table_plan(B, n, tiling.host_lengths(lengths, B, n), rows,
                          width, tiling.sm_count(DEVICE))
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
    shape; a hot-key stream; rows 7 x width 16384 by shape global."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import countsketch_update as u
    from repro_torch.kernels import ref

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
    check_scatter("p=None", k, v, ROWS, WIDTH, sd, ts, p=None)
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


def compare_samples(torch, what, samp, dst, tol, seeds, k, p, bad_streams):
    """The kernel path's sample keys against the plain state read through
    the plain estimate (``worp.onepass_sample``).  A stream's key set may
    differ only where the k-th and (k+1)-st |estimate| differ by less than
    the sum of their error bounds (a key's bound is the largest bound of the
    cells its rows read), or where the plain table is not finite."""
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
    mismatch = int((~same & ~(near_tie | bad_streams)).sum())
    n = samp.keys.shape[0]
    log(f"[main] {what} sample key sets: {int(same.sum())}/{n} identical, "
        f"{int(near_tie.sum())} near-tie streams, {int((~same).sum())} "
        f"differ, {mismatch} differ outside near ties / non-finite streams")
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
    return [
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
    kernels, errs = phase_sparse(torch, args, seeds, tseeds, tag)
    del seeds, tseeds
    torch.cuda.empty_cache()

    # -- phase 5: dense segments; phase 6: single-stream entry points -----
    entry, wg_values, dense_estimates, dense_est = phase_dense(torch, args,
                                                               tag)
    kernels.append(entry)
    single = phase_single(torch, wg_values, tag)
    kernels.extend(single)

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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
