"""The paper's experiments on the port, as ``name,us_per_call,derived``
CSV rows (the four paper sections of ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.paper [--fast] [--device cpu]

Table 3, Figure 1, Figure 2 on ``--device`` (the card by default);
Appendix B.1's simulation is host numpy.  ``--fast`` takes 10 Table 3
randomizations instead of 40.
"""
from __future__ import annotations

import argparse

from . import fig1_wor_vs_wr, fig2_rankfreq, psi_calibration, table3_nrmse
from .common import emit


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer Monte Carlo runs")
    ap.add_argument("--device", default=None,
                    help="where the samplers run (default: the card; 'cpu' "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    rows = []
    print("== Table 3: NRMSE of frequency-moment estimates ==")
    r = table3_nrmse.run(runs=10 if args.fast else 40, verbose=False,
                         device=args.device)
    rows += r; emit(r)
    print("== Figure 1: WOR vs WR ==")
    r = fig1_wor_vs_wr.run(verbose=False, device=args.device)
    rows += r; emit(r)
    print("== Figure 2: rank-frequency estimates ==")
    r = fig2_rankfreq.run(verbose=False, device=args.device)
    rows += r; emit(r)
    print("== Appendix B.1: Psi calibration ==")
    r = psi_calibration.run(verbose=False)
    rows += r; emit(r)
    print(f"== {len(rows)} paper rows done ==")
    return rows


if __name__ == "__main__":
    main()
