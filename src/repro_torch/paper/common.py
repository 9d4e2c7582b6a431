"""Shared utilities of the paper's runners: Zipf data, the one- and
two-pass WORp states of paper Sec. 7, timing and CSV rows (the port's
counterpart of ``benchmarks/common.py``).

The runners go through ``core.worp``'s plain sketch, as the reference's
do: no kernel is launched.  State lives on ``device`` (the card unless the
caller asks otherwise).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import worp


def zipf_freqs(n: int, alpha: float, seed: int = 0) -> np.ndarray:
    """freq(rank r) = (n / r)^alpha scaled -- the paper's Zipf[alpha]."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    f = ranks ** (-alpha)
    f = f / f[0] * 1000.0
    rng = np.random.default_rng(seed)
    return f[rng.permutation(n)].astype(np.float32)


def one_pass_state(freqs, k, p, seed_t, rows=5, width=None, batches=4,
                   device=None):
    """Stream the frequency vector through one-pass WORp."""
    n = len(freqs)
    width = width or 31 * k  # row width 31k -- the paper's k x 31 CountSketch
    st = worp.onepass_init(rows, width, candidates=4 * k, seed_sketch=3,
                           seed_transform=seed_t, device=device)
    dev = st.cand_keys.device
    keys = torch.arange(n, device=dev)
    fv = torch.as_tensor(freqs, device=dev)
    step = (n + batches - 1) // batches
    for lo in range(0, n, step):
        st = worp.onepass_update(st, keys[lo:lo + step], fv[lo:lo + step], p)
    return st


def two_pass_sample(freqs, k, p, seed_t, device=None, **kw):
    st1 = one_pass_state(freqs, k, p, seed_t, device=device, **kw)
    dev = st1.cand_keys.device
    n = len(freqs)
    keys = torch.arange(n, device=dev)
    fv = torch.as_tensor(freqs, device=dev)
    st2 = worp.twopass_init(capacity=2 * (k + 1), seed_transform=seed_t,
                            device=dev)
    step = (n + 3) // 4
    for lo in range(0, n, step):
        st2 = worp.twopass_update(st2, st1.sketch, keys[lo:lo + step],
                                  fv[lo:lo + step])
    return worp.twopass_sample(st2, k, p)


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn: Callable, *args, repeats: int = 3, device=None) -> float:
    """Median wall time in microseconds (the first call, which builds and
    warms up, excluded); the card synchronised inside the timed region."""
    device = device or "cuda"
    fn(*args)
    synchronize(device)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(device)
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def emit(rows):
    for name, us, derived in rows:
        print(f"{name},{us:.2f},{derived}")
