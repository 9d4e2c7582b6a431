"""Paper Appendix B.1: Psi calibration by simulating R_{n,k,rho} (the
port's counterpart of ``benchmarks/psi_calibration.py``).

Reproduces the claim: C < 2 suffices for delta = 0.01, rho in {1, 2},
k >= 10 (and C ~ 1.4 for k >= 100).  The simulation is host numpy
(``core.psi``), the reference's draws bit for bit from the same seed.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import psi


def run(n: int = 10_000, verbose: bool = True, num_samples: int = 300):
    rows = []
    for rho in (1.0, 2.0):
        for k in (10, 100, 1000):
            t0 = time.perf_counter()
            sim = psi.psi_from_simulation(n, k, rho, delta=0.01,
                                          num_samples=num_samples)
            us = (time.perf_counter() - t0) * 1e6
            if rho == 1.0:
                c = 1.0 / (sim * np.log(n / k))
            else:
                c = max(rho - 1.0, 1.0 / np.log(n / k)) / sim
            width = psi.rhh_width(n, k, rho)
            rows.append((f"psi_rho{rho:g}_k{k}", us,
                         f"psi={sim:.4f} implied_C={c:.3f} "
                         f"rhh_width={width}"))
            if verbose:
                print(rows[-1])
    return rows


if __name__ == "__main__":
    run()
