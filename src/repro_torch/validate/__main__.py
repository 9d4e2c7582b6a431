"""CLI entry point: ``PYTHONPATH=src python -m repro_torch.validate``.

Runs the conformance suite over the sampler registry on the port's planes
and prints one line per check plus the greppable ``conformance_summary,...``
line; ``--report`` writes the JSON report (the reference's schema).  The
flags and defaults are the reference's (``python -m repro.validate``), and
``--device`` picks where the trials run (the card by default).  Exit status
is nonzero on any failed check.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.sampler import available
from repro_torch.core.transforms import PPSWOR, PRIORITY

from . import conformance, empirics, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.validate",
        description="Distribution-level conformance suite over the sampler "
                    "registry, on the PyTorch port's data planes")
    ap.add_argument("--samplers", nargs="*", default=None,
                    choices=list(available()),
                    help="subset of registry samplers (default: all)")
    ap.add_argument("--schemes", nargs="*", default=[PPSWOR, PRIORITY],
                    choices=[PPSWOR, PRIORITY])
    ap.add_argument("--ps", nargs="*", type=float, default=None,
                    help="ell_p exponents (default: fast 1.0; deep "
                         "0.5 1.0 1.5 2.0)")
    ap.add_argument("--paths", nargs="*", default=list(empirics.PATHS),
                    choices=list(empirics.PATHS),
                    help="data planes (the port's plane registry): dense "
                         "(plain update), ingest (scatter kernel), async "
                         "(double-buffered worker thread), pipeline "
                         "(per-shard, merged at every read), fleet "
                         "(per-replica, merged through checkpoints)")
    ap.add_argument("--codecs", nargs="*", default=None,
                    help="lossy wire codecs for the codec-axis cells "
                         "(default: fp16 q8; deep adds size_adaptive; "
                         "pass an empty list to skip the codec axis)")
    ap.add_argument("--trials", type=int, default=None,
                    help="Monte-Carlo trials per cell (default: fast 96, "
                         "deep 384, otherwise 160)")
    ap.add_argument("--deep", action="store_true",
                    help="full grids + larger trial counts + Table-3 "
                         "golden-value rows (the nightly operating point)")
    ap.add_argument("--fast", action="store_true",
                    help="smallest useful suite (bench-smoke summary line)")
    ap.add_argument("--table3-trials", type=int, default=None,
                    help="randomizations for the Table-3 NRMSE check "
                         "(0 disables; default: 0 fast, 12 deep)")
    ap.add_argument("--seed", type=int, default=0xC0F)
    ap.add_argument("--device", default="cuda",
                    help="where the trials run (default: cuda, the card; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the JSON report here")
    args = ap.parse_args(argv)

    if args.deep:
        ps = args.ps or list(conformance.PS)
        trials = args.trials or 384
        table3 = args.table3_trials if args.table3_trials is not None else 12
        codecs = (args.codecs if args.codecs is not None
                  else ["fp16", "q8", "size_adaptive"])
    elif args.fast:
        ps = args.ps or [1.0]
        trials = args.trials or 96
        table3 = args.table3_trials or 0
        codecs = args.codecs if args.codecs is not None else ["fp16", "q8"]
    else:
        ps = args.ps or [1.0]
        trials = args.trials or 160
        table3 = args.table3_trials or 0
        codecs = args.codecs if args.codecs is not None else ["fp16", "q8"]

    cfg = conformance.ConformanceConfig(trials=trials, ref_trials=3 * trials,
                                        seed=args.seed, device=args.device)
    rep = conformance.run_suite(samplers=args.samplers, schemes=args.schemes,
                                ps=ps, paths=args.paths, cfg=cfg,
                                table3_trials=table3, codecs=codecs)
    for line in check_lines(rep):
        print(line)
    print(report.summary_line(rep))
    if args.report:
        report.write(rep, args.report)
        print(f"report written to {args.report}")
    return 0 if report.ok(rep) else 1


def check_lines(rep: dict) -> list:
    """One ``conformance_check,...`` line per result, as the reference's
    CLI prints them."""
    out = []
    for r in rep["results"]:
        d = r["details"]
        extra = (f" reason={d['reason']!r}" if r["status"] == report.SKIP
                 else f" worst_margin={d.get('worst_margin', 0):+.3g}")
        out.append(f"conformance_check,{r['check']},{r['sampler']},"
                   f"{r['scheme']},p={r['p']:g},{r['path']},{r['status']}"
                   f"{extra}")
    return out


if __name__ == "__main__":
    sys.exit(main())
