"""Statistical conformance harness of the port: distribution-level WOR
guarantees over the sampler registry, on the port's planes and kernels.

``repro_torch.validate`` is the port's counterpart of ``repro.validate``:
seeded Monte-Carlo trial ensembles (``empirics``), acceptance tolerances
derived from trial counts (``bounds``, a copy of the reference's),
named distribution-level checks (``conformance``), and machine-readable
pass/fail reports in the reference's schema (``report``).  It runs on the
card unless the caller passes ``device="cpu"``.

Run it:

    PYTHONPATH=src python -m repro_torch.validate                # fast suite
    PYTHONPATH=src python -m repro_torch.validate --deep --report out.json
    PYTHONPATH=src python -m repro_torch.validate --fast --device cpu
"""
from . import bounds, empirics, report  # noqa: F401
from .conformance import (  # noqa: F401
    BOTTOMK,
    ConformanceConfig,
    check_ht_ks,
    check_ht_unbiased,
    check_inclusion_probabilities,
    check_table3_nrmse,
    check_tv_single_draw,
    check_wor_beats_wr,
    check_wor_distinct,
    prepare_cell,
    run_cell,
    run_suite,
)
from .report import CheckResult, summary_line  # noqa: F401
