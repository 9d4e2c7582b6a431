#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Deployment: per-key analytics over B = 4096 independent turnstile streams
(one per tenant or request) at the engine's defaults -- rows 7, width 2048,
512 candidates, p = 1, ppswor, FlushPolicy(max_elems=4096).  Stream b is
``TurnstileZipfStream(vocab_size=2**20, alpha=1.2, delete_fraction=0.25)``
shard b: 4096 inserts plus 1024 retractions per step.  Eight steps are
ingested, then ``sample(k=64)``.  Device state: 4096 x 7 x 2048 x 4 B =
235 MB of tables.

Phases (each prints its own lines; any failure raises and the script exits
non-zero without the final ``ok`` line):
  1. the card, and the kernels built from ``src/repro_torch/kernels/csrc``;
  2. each kernel against its plain PyTorch version on the card;
  3. the main path: ``SketchEngine`` on the sparse plane (the kernels) and on
     the dense plane (the plain reference), from the same seeds and stream,
     and a ``torch.profiler`` trace of the sparse plane's flush stages;
  4. times: kernels, plain versions, library yardsticks, events/s, sample
     latency, peak memory;
  5. one ``{"kernels": [...]}`` line, then the ``ok`` line.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
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
# named ranges of the sparse plane's flush (engine/planes.py)
RANGES = ("plane.concat", "plane.h2d", "plane.dispatch", "sparse.scatter",
          "sparse.refresh")
DEVICE = "cuda"

# Device peaks for the bounds (H100 SXM at 700 W).  HBM3 rate from NVIDIA's
# data sheet.  The integer rate is the fp32 non-tensor rate of the data sheet
# (67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz) scaled to Hopper's 64
# INT32 lanes per SM, counting one operation per lane and clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# 32-bit operations per work item, counted from kernels/csrc/hashing.cuh:
# mix32 = 3 shifts + 3 xors + 2 multiplies = 8; hash_u32 = 2 mix32 + add +
# xor + multiply = 19; row_salt = 3; a bucket = hash + modulo = 20; a sign =
# salt xor + hash + and + select = 22; an address = 2.  The modulo counts as
# one operation, so these are lower bounds.
OPS_PER_ROW = 3 + 20 + 22 + 2
SCATTER_OPS_PER_SLOT = ROWS * OPS_PER_ROW + 24 + 2 + 3   # uniform01, log+pow,
QUERY_OPS_PER_KEY = ROWS * (OPS_PER_ROW + 1)             # mask; query: sign mul


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


def phase_parity(torch, seeds, tseeds, keys, vals, tag):
    """Each kernel against its plain version on the card: the scatter within
    rtol 1e-4 / scale-aware atol and within each cell's rounding bound, the
    query bit for bit."""
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref

    dev = keys.device
    results = {}

    def check_scatter(name, k, v, rows, width, sd, ts, **kw):
        got = s.countsketch_scatter_batched(k, v, rows, width, sd,
                                            transform_seeds=ts, **kw)
        want = ref.countsketch_scatter_batched_ref(k, v, rows, width, sd,
                                                   transform_seeds=ts, **kw)
        tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
            k, v, rows, width, sd, transform_seeds=ts, **kw))
        torch.cuda.synchronize()
        atol = scale_atol(want)
        close = torch.allclose(got, want, rtol=RTOL, atol=atol,
                               equal_nan=True)
        cells, err, ratio = cell_check(torch, got, want, tol)
        nonfinite = int((~want.isfinite()).sum())
        log(f"[parity] scatter {name}: shape {tuple(got.shape)} "
            f"max_abs_err {err:.3e}; allclose atol {atol:.3e} "
            f"{'ok' if close else 'FAIL'}; per-cell bound worst err/bound "
            f"{ratio:.3e} {'ok' if cells else 'FAIL'}; nonfinite "
            f"{nonfinite}")
        if not (close and cells):
            raise AssertionError(f"scatter kernel disagrees ({name})")
        ratios.append(ratio)
        return got, err

    # deployment shape: one flush of a full step, fused ppswor p=1
    ratios = []
    table, results["scatter"] = check_scatter("deployment", keys, vals, ROWS,
                                              WIDTH, seeds, tseeds, p=P)

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

    def check_query(name, tables, qk, sd):
        got = q.countsketch_query_batched(tables, qk, sd)
        want = ref.countsketch_query_batched_ref(tables, qk, sd)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        log(f"[parity] query {name}: shape {tuple(got.shape)} bitwise "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"query kernel is not bitwise ({name})")

    qkeys = torch.cat([torch.full((B, CANDIDATES), -1, dtype=torch.int32,
                                  device=dev), keys], 1).contiguous()
    check_query("deployment (candidates + batch)", table, qkeys, seeds)
    tables = torch.randn((8, 5, 1000), generator=g).to(dev)
    check_query("W=1000,k=1", tables, k[:, :1].contiguous(), sd)
    check_query("B=1", tables[:1].contiguous(), k[:1].contiguous(), sd[:1])
    results["query"] = 0.0
    log(f"[parity] all kernels agree with their plain versions {tag}")
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


def profile_window(torch, steps, tag):
    """torch.profiler over two flushes and one sample of a fresh sparse
    engine: the flush's named stages (host time, and the device time of the
    PyTorch ops each launched), device time by kernel, and the device's
    busy share."""
    from torch.autograd import DeviceType
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
    # device-side activities only (kernels, copies, memsets): the host ops
    # that launched them carry the same device time a second time, and the
    # device-side copies of the named ranges span their kernels
    rows, stages = [], {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if e.key in RANGES:
            if e.device_type == DeviceType.CPU:
                incl = getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
                stages[e.key] = (e.count, e.cpu_time_total / 1e3, incl / 1e3)
        elif dev_us > 0 and e.device_type != DeviceType.CPU:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    for name in RANGES:
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
        return
    log(f"[profile] 2 flushes + sample: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f} %), idle "
        f"{100 * (1 - busy / wall_ms):.1f} % (traced run) {tag}")
    for ms, count, key in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated turnstile stream")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import countsketch, transforms, worp
    from repro_torch.engine import FlushPolicy, derive_stream_seeds
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import countsketch_query as q
    from repro_torch.kernels import countsketch_scatter as s
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # -- phase 1: the card and the build --------------------------------
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

    t0 = time.perf_counter()
    stream, steps = make_stream(args.seed)
    events = sum(k.size for k, _ in steps)
    log(f"[stream] generated {STEPS} steps x {B} streams = {events} signed "
        f"events on the host in {time.perf_counter() - t0:.2f} s (kept out "
        f"of the ingest rate)")

    # -- phase 2: kernel parity -----------------------------------------
    cfg = EngineConfig(num_streams=B, rows=ROWS, width=WIDTH,
                       candidates=CANDIDATES, p=P)
    seeds, tseeds = derive_stream_seeds(cfg, device=dev)
    keys1 = torch.from_numpy(steps[1][0]).to(dev)
    vals1 = torch.from_numpy(steps[1][1]).to(dev)
    errs, table, qkeys = phase_parity(torch, seeds, tseeds, keys1, vals1, tag)

    # -- phase 3: the main path, sparse (kernels) and dense (plain) -------
    policy = FlushPolicy(max_elems=4096)
    s.launches = q.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng, samp, flushes, ingest_s, sample_s = run_engine(torch, "sparse",
                                                        steps, policy)
    scatter_launches, query_launches = s.launches, q.launches
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"[main] sparse plane: {flushes} flushes, scatter launches "
        f"{scatter_launches}, query launches {query_launches}")
    if scatter_launches != flushes or flushes == 0:
        raise AssertionError("scatter launches do not match the flushes")
    if query_launches < flushes + 1:
        raise AssertionError("query launches < flushes + 1")
    st = eng.state
    if tuple(samp.keys.shape) != (B, K) or samp.keys.dtype != torch.int32:
        raise AssertionError(f"sample keys shape {tuple(samp.keys.shape)}")

    dense, _, dflushes, dense_s, _ = run_engine(torch, "dense", steps,
                                                policy, sample=False)
    dst = dense.state
    dt = dst.sketch.table
    # each cell's rounding bound over all steps: any summation order of its
    # terms, the sparse plane's per-flush deltas included
    cnt = torch.zeros_like(dt)
    mass = torch.zeros_like(dt)
    for keys, vals in steps:
        c, m = ref.countsketch_scatter_mass_ref(
            torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev),
            ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
        cnt += c
        mass += m
    tol = ref.scatter_tolerance(cnt, mass)
    del cnt, mass, c, m
    atol = scale_atol(dt)
    close = torch.allclose(st.sketch.table, dt, rtol=RTOL, atol=atol,
                           equal_nan=True)
    cells, t_err, t_ratio = cell_check(torch, st.sketch.table, dt, tol)
    bad_streams = (~dt.isfinite()).flatten(1).any(1)
    log(f"[main] sparse vs dense tables: max_abs_err {t_err:.3e}; allclose "
        f"rtol {RTOL} atol {atol:.3e}: {'ok' if close else 'FAIL'}; "
        f"per-cell bound worst err/bound {t_ratio:.3e}: "
        f"{'ok' if cells else 'FAIL'}; streams with non-finite cells (the "
        f"reference's uniform01 == 1.0 edge): {int(bad_streams.sum())}")
    if not (close and cells):
        raise AssertionError("sparse and dense plane tables disagree")
    # the reference sample: the dense state read through the plain estimate
    dsamp = worp.onepass_sample(dst, K, P)
    # a stream's key set may differ only where the k-th and (k+1)-st
    # |estimate| differ by less than the sum of their error bounds; a key's
    # bound is the largest bound of the cells its rows read
    cand = dst.cand_keys
    mag = torch.where(cand == -1, float("-inf"),
                      countsketch.estimate(dst.sketch, cand).abs())
    top_mag, top_i = worp.top_k(mag, K + 1)
    key_err = ref.countsketch_query_batched_ref(tol, cand, seeds).abs()
    pair_err = torch.gather(key_err.amax(1), 1, top_i[:, K - 1:K + 1])
    near_tie = (top_mag[:, K - 1] - top_mag[:, K]) <= pair_err.sum(1)
    del tol, key_err
    same = (torch.sort(samp.keys, 1).values
            == torch.sort(dsamp.keys, 1).values).all(1)
    excused = near_tie | bad_streams
    mismatch = int((~same & ~excused).sum())
    log(f"[main] sample key sets: {int(same.sum())}/{B} identical, "
        f"{int(near_tie.sum())} near-tie streams, {int((~same).sum())} "
        f"differ, {mismatch} differ outside near ties / non-finite streams")
    if mismatch:
        raise AssertionError("sample key sets differ between planes")
    good = ~bad_streams
    if not bool(samp.freqs[good].isfinite().all()):
        raise AssertionError("non-finite sample frequencies")

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
    del dense, dst, dt
    profile_window(torch, steps, tag)

    # -- phase 4: times --------------------------------------------------
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

    n1 = keys1.shape[1]
    scatter = lambda: s.countsketch_scatter_batched(  # noqa: E731
        keys1, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
    scatter_plain = lambda: ref.countsketch_scatter_batched_ref(  # noqa: E731
        keys1, vals1, ROWS, WIDTH, seeds, p=P, transform_seeds=tseeds)
    # library yardstick, memory half only: precomputed flat indices and
    # signed transformed values into a zeroed table with index_add_
    from repro_torch.core import hashing
    tv = transforms.transform_values(keys1, vals1, P, tseeds[:, None])
    idx, sv = [], []
    base = torch.arange(B, device=dev)[:, None] * (ROWS * WIDTH)
    for r in range(ROWS):
        salt = hashing.row_salt(seeds[:, None], r)
        idx.append(base + r * WIDTH + hashing.bucket_hash(keys1, salt, WIDTH))
        sv.append(hashing.sign_hash(keys1, salt) * tv)
    idx = torch.cat(idx, 1).reshape(-1)
    sv = torch.cat(sv, 1).reshape(-1)
    flat = torch.zeros(B * ROWS * WIDTH, device=dev)
    scatter_lib = lambda: flat.zero_().index_add_(0, idx, sv)  # noqa: E731
    s_ms = cuda_ms(torch, scatter, 20)
    s_plain = cuda_ms(torch, scatter_plain, 3, warmup=1)
    s_lib = cuda_ms(torch, scatter_lib, 20)
    del idx, sv, flat, tv

    query = lambda: q.countsketch_query_batched(table, qkeys,  # noqa: E731
                                                seeds)
    query_plain = lambda: ref.countsketch_query_batched_ref(  # noqa: E731
        table, qkeys, seeds)
    kq = qkeys.shape[1]
    gidx = []
    for r in range(ROWS):
        salt = hashing.row_salt(seeds[:, None], r)
        gidx.append(r * WIDTH + hashing.bucket_hash(qkeys, salt, WIDTH))
    gidx = torch.cat(gidx, 1)
    flat_tables = table.reshape(B, ROWS * WIDTH)
    query_lib = lambda: torch.gather(flat_tables, 1, gidx)  # noqa: E731
    q_ms = cuda_ms(torch, query, 20)
    q_plain = cuda_ms(torch, query_plain, 3, warmup=1)
    q_lib = cuda_ms(torch, query_lib, 20)
    del gidx

    # bounds from this run's inputs: each input read once, each output
    # written once; integer work for the slots/keys this data makes live
    live = int((keys1 != -1).sum())
    s_bytes = keys1.numel() * 8 + B * ROWS * WIDTH * 4
    s_ops = live * SCATTER_OPS_PER_SLOT
    q_bytes = qkeys.numel() * 4 + table.numel() * 4 + B * ROWS * kq * 4
    q_ops = qkeys.numel() * QUERY_OPS_PER_KEY

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    s_bound, s_by = bound(s_bytes, s_ops)
    q_bound, q_by = bound(q_bytes, q_ops)
    log(f"[time] scatter (B={B}, n={n1}): kernel {s_ms:.4f} ms, plain "
        f"{s_plain:.4f} ms, index_add_ yardstick (memory half only) "
        f"{s_lib:.4f} ms, bound {s_bound:.4f} ms by {s_by} "
        f"({s_bytes / 1e6:.1f} MB, {s_ops / 1e9:.2f} G int ops) {tag}")
    log(f"[time] query (B={B}, k={kq}): kernel {q_ms:.4f} ms, plain "
        f"{q_plain:.4f} ms, gather yardstick (memory half only) "
        f"{q_lib:.4f} ms, bound {q_bound:.4f} ms by {q_by} "
        f"({q_bytes / 1e6:.1f} MB, {q_ops / 1e9:.2f} G int ops) {tag}")

    # -- phase 5: the kernels line and the ok line -------------------------
    kernels = [
        {"name": "countsketch_scatter_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_scatter.cu",
         "replaces": "src/repro/kernels/countsketch_scatter.py:112",
         "launches": scatter_launches, "max_abs_err": errs["scatter"],
         "parity": f"allclose rtol {RTOL} atol 1e-5*max(1,max|want|) and "
                   f"per-cell eps32*(m+{ref.TRANSFORM_ULPS})*sum|term|",
         "worst_err_over_bound": errs["scatter_ratio"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": s_lib},
        {"name": "countsketch_query_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/countsketch_query.cu",
         "replaces": "src/repro/kernels/countsketch_query.py:150",
         "launches": query_launches, "max_abs_err": errs["query"],
         "parity": "bitwise", "ms": q_ms, "plain_ms": q_plain,
         "bound_ms": q_bound, "bound_by": q_by, "library_ms": q_lib},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
