"""Paper Table 3: NRMSE of frequency-moment estimates from ell_p samples
(the port's counterpart of ``benchmarks/table3_nrmse.py``).

Rows: (ell_p, Zipf[alpha], power p') with perfect WR, perfect WOR
(p-ppswor), 1-pass WORp, 2-pass WORp.  n = 10^4, k = 100, CountSketch ~ k
x 31, averaged over ``runs`` randomizations -- the paper's exact setup
(Sec. 7).  The WOR samples come from hashed seeds and are the reference's
key for key; the WR draws come from a ``torch.Generator`` seeded per run,
where the reference draws from a JAX PRNG key, so the ``wr`` column agrees
with the reference's in distribution only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import estimators, perfect, worp
from repro_torch.core.device import resolve_device
from repro_torch.validate.table3 import PAPER, ROWS

from .common import one_pass_state, synchronize, two_pass_sample, zipf_freqs


def wr_moment(freqs, k, p, power, generator) -> float:
    f = torch.as_tensor(freqs, device=generator.device)
    draws = perfect.wr_sample(f, k, p, generator).cpu().numpy()
    w = np.abs(freqs).astype(np.float64)
    probs = (w ** p) / (w ** p).sum()
    return float(((w[draws] ** power) / (k * probs[draws])).sum())


def run_samples(freqs, k, p, seed_t, device):
    """The three WOR samples of one randomization: perfect p-ppswor, 1-pass
    and 2-pass WORp, all from transform seed ``seed_t``."""
    f = torch.as_tensor(freqs, device=device)
    return {"wor": perfect.ppswor_sample(f, k, p, seed_t),
            "one": worp.onepass_sample(
                one_pass_state(freqs, k, p, seed_t, device=device), k, p),
            "two": two_pass_sample(freqs, k, p, seed_t, device=device)}


def run(n: int = 10_000, k: int = 100, runs: int = 40, verbose: bool = True,
        device=None, estimates: dict = None):
    """The five rows as ``(name, us_per_run, derived)``; ``estimates``, if
    given, receives each row's per-run estimates by method."""
    dev = resolve_device(device)
    out_rows = []
    for (p, alpha, power) in ROWS:
        freqs = zipf_freqs(n, alpha, seed=int(alpha * 10))
        truth = float((np.abs(freqs).astype(np.float64) ** power).sum())
        est = {m: [] for m in ("wr", "wor", "one", "two")}
        t0 = time.perf_counter()
        for t in range(runs):
            seed_t = 5000 + t
            # same p-ppswor randomization for all WOR methods (paper Sec. 7)
            for m, s in run_samples(freqs, k, p, seed_t, dev).items():
                est[m].append(float(estimators.frequency_moment(
                    s, p, power)))
            gen = torch.Generator(dev).manual_seed(t)
            est["wr"].append(wr_moment(freqs, k, p, power, gen))
        synchronize(dev)
        us = (time.perf_counter() - t0) * 1e6 / runs
        nr = {m: estimators.nrmse(np.array(v), truth)
              for m, v in est.items()}
        name = f"table3_l{p:g}_zipf{alpha:g}_pow{power:g}"
        derived = (f"wr={nr['wr']:.2e} wor={nr['wor']:.2e} "
                   f"one={nr['one']:.2e} two={nr['two']:.2e} "
                   f"paper_wor={PAPER[(p, alpha, power)]['wor']:.2e}")
        out_rows.append((name, us, derived))
        if estimates is not None:
            estimates[(p, alpha, power)] = est
        if verbose:
            print(f"{name}: {derived}")
    return out_rows


if __name__ == "__main__":
    run()
