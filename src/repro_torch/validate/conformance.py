"""Named distribution-level conformance checks over the sampler registry.

The port's counterpart of ``repro.validate.conformance``: the same checks,
the same tolerances derived by the same ``bounds`` calls, over the port's
planes and kernels on ``ConformanceConfig.device`` (the card unless the
caller asks otherwise).  Each check validates one of the paper's
distributional guarantees against Monte-Carlo trial ensembles
(``empirics``) with tolerances DERIVED from the trial counts and failure
budget (``bounds``) -- no hand-tuned epsilons:

  check_inclusion_probabilities   per-key inclusion frequencies of the
      sampler match the exact bottom-k oracle's, within a two-sample
      binomial radius (union-bounded over keys) plus -- for samplers that
      rank by ESTIMATED nu* -- a sketch-noise flip allowance computed from
      the reference randomization ensemble and the sketch geometry.
  check_ht_unbiased               Horvitz-Thompson sum/moment estimates
      (Eq. 2) are unbiased: |mean_T - truth| within the CLT radius on the
      empirical std, plus the Theorem-5.1 bias allowance for estimated-
      frequency samplers.
  check_ht_ks                     the WHOLE HT-estimate distribution is
      data-plane invariant: two-sample Kolmogorov-Smirnov against the SAME
      spec on the dense reference plane under a disjoint trial seed bank,
      within the pure two-sample DKW radius.
  check_wor_distinct              every trial's live sample keys are
      distinct, and bottom-k samplers fill all k slots.
  check_wor_beats_wr              on skewed data the WOR estimator beats
      perfect WITH-replacement sampling -- a paired sign test over trials
      against the one-sided Hoeffding win threshold.
  check_tv_single_draw            the tv cascade's first extraction is a
      single ell_p draw.
  check_table3_nrmse              frequency-moment NRMSE against the
      paper's Table 3 golden values (``table3.PAPER``), within chi-square
      measurement factors and the fp32 accumulation floor.

Every check returns a ``report.CheckResult``; ``run_suite`` sweeps sampler
x scheme x p x data-plane cells and builds the JSON report (the
reference's schema).

Wire codecs: the codec axis (lossy codecs on the ``pipeline`` and
``fleet`` planes, their admissibility gate and negative control) comes
with the port's codecs (ROADMAP Queue 1 item 6).  Until then ``"none"`` is
the only codec accepted, and its widenings are zero, as the reference's
are for a lossless codec.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import transforms
from repro_torch.core.device import resolve_device
from repro_torch.core.sampler import SamplerSpec, available

from . import bounds, empirics
from .report import FAIL, PASS, SKIP, CheckResult, build

# Samplers whose sample IS a bottom-k sample of the transformed frequencies
# (the tv cascade draws by a different, non-bottom-k process).
BOTTOMK = ("onepass", "perfect", "twopass")
# Samplers that rank by sketch-ESTIMATED transformed frequencies and
# therefore get the derived sketch-noise/bias allowances.
ESTIMATED = ("onepass", "twopass", "tv")

SCHEMES = (transforms.PPSWOR, transforms.PRIORITY)
PS = (0.5, 1.0, 1.5, 2.0)

CODEC_ITEM = "ROADMAP Queue 1 item 6 (the wire codecs)"


def _lossless(codec: str) -> None:
    """Accept the lossless codec only: the codec axis is not ported yet."""
    if codec != "none":
        raise NotImplementedError(
            f"wire codec {codec!r} is not ported yet (only 'none'); the "
            f"codec axis comes with {CODEC_ITEM}")


class ConformanceConfig(NamedTuple):
    """Suite operating point.  Trial counts set the tolerances (bounds.*);
    the sketch geometry defaults to the paper's k x 31 CountSketch.
    ``device`` is where the trials run: the card when None."""

    n: int = 96               # key-domain size of the trial streams
    k: int = 8                # sample size
    trials: int = 160         # Monte-Carlo trials for the sampler under test
    ref_trials: int = 480     # oracle reference trials (tighter reference)
    delta: float = 1e-3       # per-check failure probability budget
    alpha: float = 2.0        # Zipf skew of the trial frequency vector
    seed: int = 0xC0F         # base seed for the trial seed banks
    ref_offset: int = 1 << 20  # disjoint seed bank for the oracle reference
    chunks: int = 3           # stream is fed in this many element batches
    rows: int = 5             # sketch rows
    num_samplers: int = 8     # tv cascade length
    codec: str = "none"       # wire codec the sharded planes merge through
    device: Optional[str] = None  # where the trials run (None: the card)


class CellData(NamedTuple):
    """Shared per-cell trial data so the named checks don't re-run trials."""

    freqs: np.ndarray
    spec: SamplerSpec
    sample: object            # batched Sample, leading (T,) axis
    state: object             # final batched sampler state
    ref_sample: object        # oracle batched Sample (bottom-k reference)
    ref_tstar: np.ndarray     # (T_ref, n) exact transformed frequencies
    ref_thresholds: np.ndarray


def _spec(name: str, p: float, scheme: str, cfg: ConformanceConfig
          ) -> SamplerSpec:
    return empirics.spec_for(name, cfg.n, cfg.k, p, scheme, rows=cfg.rows,
                             num_samplers=cfg.num_samplers)


def _freqs(cfg: ConformanceConfig) -> np.ndarray:
    return empirics.zipf_freqs(cfg.n, cfg.alpha, seed=cfg.seed & 0xFF)


# The oracle reference ensemble depends only on (scheme, p, cfg), not on
# the sampler or data plane under test -- cache it so a grid sweep computes
# each distinct reference once.  ``cfg`` carries the device, so an ensemble
# computed on one device never serves a cell on another.
_REF_CACHE: dict = {}


def _reference(freqs, p: float, scheme: str, cfg: ConformanceConfig):
    key = (scheme, p, cfg)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = empirics.perfect_trials(
            freqs, cfg.k, p, scheme, cfg.ref_trials, cfg.seed,
            offset=cfg.ref_offset, device=cfg.device)
    return _REF_CACHE[key]


def prepare_cell(name: str, scheme: str, p: float, path: str,
                 cfg: ConformanceConfig,
                 spec: Optional[SamplerSpec] = None) -> CellData:
    """Run the cell's trials once (sampler + cached oracle reference)."""
    _lossless(cfg.codec)
    freqs = _freqs(cfg)
    spec = spec if spec is not None else _spec(name, p, scheme, cfg)
    sample, state = empirics.run_trials(spec, freqs, cfg.k, cfg.trials,
                                        cfg.seed, path=path,
                                        chunks=cfg.chunks, codec=cfg.codec,
                                        device=cfg.device)
    ref_sample, tstar, thr = _reference(freqs, p, scheme, cfg)
    return CellData(freqs=freqs, spec=spec, sample=sample, state=state,
                    ref_sample=ref_sample, ref_tstar=tstar,
                    ref_thresholds=thr)


def _data(name, scheme, p, path, cfg, spec, data):
    return data if data is not None else prepare_cell(name, scheme, p, path,
                                                      cfg, spec=spec)


def _power(power: float):
    return lambda w: torch.abs(w) ** power


# ---------------------------------------------------------------------------
# named checks
# ---------------------------------------------------------------------------

def check_inclusion_probabilities(name: str, scheme: str, p: float,
                                  path: str, cfg: ConformanceConfig,
                                  spec: Optional[SamplerSpec] = None,
                                  data: Optional[CellData] = None
                                  ) -> CheckResult:
    """Per-key inclusion frequencies match the exact bottom-k oracle."""
    if name not in BOTTOMK and spec is None:
        return CheckResult("inclusion_probabilities", name, scheme, p, path,
                           SKIP, {"reason": "not a bottom-k sampler"})
    data = _data(name, scheme, p, path, cfg, spec, data)
    emp = empirics.inclusion_counts(data.sample.keys, cfg.n) / cfg.trials
    ref = empirics.inclusion_counts(data.ref_sample.keys,
                                    cfg.n) / cfg.ref_trials
    tol = bounds.two_sample_radius(emp, cfg.trials, ref, cfg.ref_trials,
                                   cfg.delta, support=cfg.n)
    flip = np.zeros(cfg.n)
    if name in ESTIMATED:
        flip = bounds.countsketch_flip_probability(
            data.ref_tstar, data.ref_thresholds,
            width=data.spec.cfg.width, rows=data.spec.cfg.rows)
        tol = tol + flip
    dev = np.abs(emp - ref)
    worst = int(np.argmax(dev - tol))
    margin = float((dev - tol)[worst])
    return CheckResult(
        "inclusion_probabilities", name, scheme, p, path,
        PASS if margin <= 0 else FAIL,
        {"worst_margin": margin, "worst_key": worst,
         "worst_emp": float(emp[worst]), "worst_ref": float(ref[worst]),
         "worst_tol": float(tol[worst]),
         "mean_abs_dev": float(dev.mean()),
         "mean_flip_allowance": float(np.mean(flip)),
         "mean_quant_flip_allowance": 0.0,  # lossless wire
         "trials": cfg.trials, "ref_trials": cfg.ref_trials})


def check_ht_unbiased(name: str, scheme: str, p: float, path: str,
                      cfg: ConformanceConfig,
                      spec: Optional[SamplerSpec] = None,
                      data: Optional[CellData] = None) -> CheckResult:
    """HT sum/moment estimates are unbiased within CLT + bias allowance."""
    if name not in BOTTOMK and spec is None:
        return CheckResult("ht_unbiased", name, scheme, p, path, SKIP,
                           {"reason": "no bottom-k threshold (HT undefined)"})
    data = _data(name, scheme, p, path, cfg, spec, data)
    powers = (1.0, 2.0)
    details, margin = {}, -np.inf
    for power in powers:
        est = empirics.ht_estimates(data.sample, p, _power(power), scheme)
        truth = empirics.moment_truth(data.freqs, power)
        radius = bounds.clt_mean_radius(float(est.std(ddof=1)), cfg.trials,
                                        cfg.delta / len(powers))
        allowance = 0.0
        if name in ESTIMATED:
            allowance = bounds.sketch_bias_allowance(
                truth, cfg.k, data.spec.cfg.width)
        m = abs(float(est.mean()) - truth) - radius - allowance
        details[f"pow{power:g}"] = {
            "mean": float(est.mean()), "truth": truth,
            "clt_radius": radius, "bias_allowance": allowance,
            "quant_allowance": 0.0,  # lossless wire
            "rel_err": abs(float(est.mean()) - truth) / truth}
        margin = max(margin, m / truth)  # relative, comparable across powers
    details["worst_margin"] = float(margin)
    details["trials"] = cfg.trials
    return CheckResult("ht_unbiased", name, scheme, p, path,
                       PASS if margin <= 0 else FAIL, details)


# Disjoint-seed-bank dense-plane HT ensembles for the KS check.  The key
# includes the SPEC (``make_sampler`` is cached, so registry specs are
# identical objects across a path sweep and each reference is computed
# once) -- injected custom specs (the negative-control hook) therefore get
# their own reference -- and ``cfg``, which carries the device.
_KS_REF_CACHE: dict = {}


def _ks_reference(name: str, scheme: str, p: float,
                  cfg: ConformanceConfig, spec: SamplerSpec):
    key = (name, scheme, p, cfg, spec)
    if key not in _KS_REF_CACHE:
        sample, _ = empirics.run_trials(
            spec, _freqs(cfg), cfg.k, cfg.trials, cfg.seed,
            path=empirics.DENSE, chunks=cfg.chunks,
            offset=2 * cfg.ref_offset, device=cfg.device)
        _KS_REF_CACHE[key] = sample
    return _KS_REF_CACHE[key]


def check_ht_ks(name: str, scheme: str, p: float, path: str,
                cfg: ConformanceConfig,
                spec: Optional[SamplerSpec] = None,
                data: Optional[CellData] = None) -> CheckResult:
    """Two-sample KS on HT-estimate DISTRIBUTIONS across data planes.

    Compares the full empirical CDF of the cell's per-trial HT sum
    estimates (power 1) against the SAME spec run on the dense reference
    plane under a DISJOINT trial seed bank, within the pure two-sample DKW
    radius: both sides carry identical sketch noise, so a kernel-plane
    drift (scatter bias, transform skew, seed plumbing) surfaces as a KS
    failure even when every point test passes.  On the dense plane itself
    the check is a seed-bank independence control.
    """
    if name not in BOTTOMK and spec is None:
        return CheckResult("ht_ks", name, scheme, p, path, SKIP,
                           {"reason": "no bottom-k threshold (HT undefined)"})
    data = _data(name, scheme, p, path, cfg, spec, data)
    est = empirics.ht_estimates(data.sample, p, torch.abs, scheme)
    ref_sample = _ks_reference(name, scheme, p, cfg, data.spec)
    ref = empirics.ht_estimates(ref_sample, p, torch.abs, scheme)
    ks = empirics.ks_statistic(est, ref)
    tol = bounds.two_sample_ks_radius(cfg.trials, cfg.trials, cfg.delta)
    margin = ks - tol
    return CheckResult(
        "ht_ks", name, scheme, p, path, PASS if margin <= 0 else FAIL,
        {"ks": ks, "ks_radius": tol, "worst_margin": float(margin),
         "trials": cfg.trials, "reference": "dense plane, disjoint seed "
         "bank (offset 2*ref_offset)"})


def check_wor_distinct(name: str, scheme: str, p: float, path: str,
                       cfg: ConformanceConfig,
                       spec: Optional[SamplerSpec] = None,
                       data: Optional[CellData] = None) -> CheckResult:
    """Samples are WOR: live keys distinct; bottom-k fills all k slots."""
    data = _data(name, scheme, p, path, cfg, spec, data)
    distinct = empirics.distinctness(data.sample.keys)
    live = empirics.live_fraction(data.sample.keys)
    ok = bool(distinct.all())
    if name in BOTTOMK:
        # k <= true support and candidates >= k: every slot must be live.
        ok = ok and live == 1.0
    else:
        ok = ok and live > 0.0
    return CheckResult(
        "wor_distinct", name, scheme, p, path, PASS if ok else FAIL,
        {"distinct_fraction": float(distinct.mean()), "live_fraction": live,
         "worst_margin": 0.0 if ok else 1.0, "trials": cfg.trials})


def check_wor_beats_wr(name: str, scheme: str, p: float, path: str,
                       cfg: ConformanceConfig,
                       spec: Optional[SamplerSpec] = None,
                       data: Optional[CellData] = None) -> CheckResult:
    """Paired sign test: the sampler's HT moment estimate beats perfect WR
    per trial more often than a coin flip can explain (skewed data).

    The one-pass estimator only dominates WR in the paper's heavy-skew,
    high-power regimes (Table 3: p <= 1, power 3); outside them the check
    is skipped.  The WR draws come from a torch generator (the reference's
    from a JAX key): the same distribution, other draws.
    """
    if name not in BOTTOMK and spec is None:
        return CheckResult("wor_beats_wr", name, scheme, p, path, SKIP,
                           {"reason": "no bottom-k HT estimator"})
    if name == "onepass" and p > 1.0:
        return CheckResult(
            "wor_beats_wr", name, scheme, p, path, SKIP,
            {"reason": "paper claims one-pass advantage only for p <= 1 "
                       "high-power moments (Table 3)"})
    power = 3.0
    data = _data(name, scheme, p, path, cfg, spec, data)
    truth = empirics.moment_truth(data.freqs, power)
    wor = empirics.ht_estimates(data.sample, p, _power(power), scheme)
    wr = empirics.wr_moment_estimates(data.freqs, cfg.k, p, power,
                                      cfg.trials, cfg.seed ^ 0x5A5A,
                                      device=cfg.device)
    wins = int(np.sum(np.abs(wor - truth) < np.abs(wr - truth)))
    need = bounds.sign_test_min_wins(cfg.trials, cfg.delta)
    return CheckResult(
        "wor_beats_wr", name, scheme, p, path,
        PASS if wins >= need else FAIL,
        {"wins": wins, "min_wins": need, "trials": cfg.trials,
         "power": power, "worst_margin": float(need - wins),
         "nrmse_wor": empirics.nrmse(wor, truth),
         "nrmse_wr": empirics.nrmse(wr, truth)})


def check_tv_single_draw(name: str, scheme: str, p: float, path: str,
                         cfg: ConformanceConfig,
                         spec: Optional[SamplerSpec] = None,
                         data: Optional[CellData] = None) -> CheckResult:
    """The tv cascade's FIRST extraction is a single ell_p draw.

    Under the ppswor randomizer the first cascade sampler's argmax of
    nu_x / e_x^{1/p} (e ~ Exp[1]) is an EXACT pps draw of nu^p:
    P[draw = x] = |nu_x|^p / ||nu||_p^p (the exponential race).  The check
    compares the empirical marginal of the first extracted key against
    that closed form, within a binomial radius (union over keys) plus a
    derived argmax-flip allowance from the cascade sketch geometry and the
    observed extraction-failure rate.  Priority-scheme cascades have no
    closed-form marginal -> skip.
    """
    if name != "tv":
        return CheckResult("tv_single_draw", name, scheme, p, path, SKIP,
                           {"reason": "tv cascade only"})
    if scheme != transforms.PPSWOR:
        return CheckResult(
            "tv_single_draw", name, scheme, p, path, SKIP,
            {"reason": "closed-form single-draw marginal requires the "
                       "ppswor (Exp[1]) randomizer"})
    data = _data(name, scheme, p, path, cfg, spec, data)
    first = empirics.to_numpy(data.sample.keys)[:, 0]
    fail_rate = float((first < 0).mean())
    emp = np.bincount(first[first >= 0], minlength=cfg.n)[:cfg.n] \
        / cfg.trials
    w = np.abs(np.asarray(data.freqs, np.float64)) ** p
    ref = w / w.sum()
    # argmax-flip allowance: per trial, sketch noise can swap the top of
    # the first cascade sampler; bound via the exact per-trial transformed
    # values y (reconstructed from the state's own transform seeds, all
    # trials in one batched transform) and the top-1/top-2 gap, Chebyshev
    # per row + Chernoff majority on the median.
    t0 = data.state.transform_seeds[:, 0]
    y = np.abs(empirics.to_numpy(transforms.transform_frequencies(
        torch.arange(cfg.n, dtype=torch.int32, device=t0.device),
        torch.tensor(np.asarray(data.freqs, np.float32), device=t0.device),
        p, t0[:, None], scheme)))
    top2 = np.sort(y, axis=1)[:, -2:]                   # (T, 2)
    gap = np.maximum(top2[:, 1] - top2[:, 0], 1e-30)    # top-1/top-2 gap
    mass = np.sum(y ** 2, axis=1)
    q = mass / (data.spec.cfg.width * gap ** 2)
    flip = float(np.mean(bounds.median_flip_bound(
        q, data.spec.cfg.rows)))
    # ref is the exact closed form, so only the empirical side needs a
    # binomial radius; flips and failed extractions are one-sided slack.
    tol = (bounds.binomial_radius(emp, cfg.trials, cfg.delta,
                                  support=cfg.n) + flip + fail_rate)
    dev = np.abs(emp - ref)
    worst = int(np.argmax(dev - tol))
    margin = float((dev - tol)[worst])
    return CheckResult(
        "tv_single_draw", name, scheme, p, path,
        PASS if margin <= 0 else FAIL,
        {"worst_margin": margin, "worst_key": worst,
         "worst_emp": float(emp[worst]), "worst_ref": float(ref[worst]),
         "flip_allowance": flip, "fail_rate": fail_rate,
         "trials": cfg.trials})


# Assumed trial count behind the paper's reported Table 3 numbers (the
# benchmark reproduction's default); sets the golden values' own
# chi-square uncertainty in check_table3_nrmse.
PAPER_RUNS = 40

# Paper-claimed methods reproduced by the registry: golden-value key ->
# how to measure it here.
_TABLE3_METHODS = ("wor", "one", "two")


def check_table3_nrmse(trials: int = 12, delta: float = 1e-3,
                       rows: Optional[Sequence] = None,
                       methods: Sequence[str] = _TABLE3_METHODS,
                       n: int = 10_000, k: int = 100,
                       seed: int = 0x7AB3, path: str = "dense",
                       codec: str = "none", device=None) -> list:
    """Frequency-moment NRMSE vs the paper's Table 3 golden values.

    For each (p, alpha, power) row, measure NRMSE over ``trials`` fresh
    randomizations for perfect WOR ('wor'), one-pass WORp ('one') and
    two-pass WORp ('two'), and require
        measured <= golden * F_meas / f_paper + floor
    where F_meas / f_paper are the chi-square factors bounding how far a
    ``trials``-run (resp. PAPER_RUNS-run) NRMSE estimate can sit from its
    population value, and the floor is the float32 accumulation limit --
    golden values below it (1e-10 rows) are not reachable in fp32.  (The
    reference adds a wire-quantization allowance for a lossy ``codec``;
    with the lossless codec, the only one ported, it is zero.)  Returns
    one CheckResult per (row, method).
    """
    from .table3 import PAPER, ROWS  # golden values

    _lossless(codec)
    rows = list(rows if rows is not None else ROWS)
    d_each = delta / (len(rows) * len(methods))
    factor = (bounds.nrmse_upper_factor(trials, d_each)
              / bounds.nrmse_lower_factor(PAPER_RUNS, d_each))
    floor = bounds.fp32_nrmse_floor(k)
    results = []
    for (p, alpha, power) in rows:
        freqs = empirics.zipf_freqs(n, alpha, seed=int(alpha * 10))
        truth = empirics.moment_truth(freqs, power)
        f = _power(power)
        measured = {}
        if "wor" in methods:
            s, _, _ = empirics.perfect_trials(freqs, k, p, transforms.PPSWOR,
                                              trials, seed, device=device)
            measured["wor"] = empirics.nrmse(
                empirics.ht_estimates(s, p, f), truth)
        for method, name in (("one", "onepass"), ("two", "twopass")):
            if method in methods:
                spec = empirics.spec_for(name, n, k, p, transforms.PPSWOR)
                s, _ = empirics.run_trials(spec, freqs, k, trials, seed,
                                           path=path, chunks=4, codec=codec,
                                           device=device)
                measured[method] = empirics.nrmse(
                    empirics.ht_estimates(s, p, f), truth)
        for method, got in measured.items():
            golden = PAPER[(p, alpha, power)][method]
            tol = golden * factor + floor
            results.append(CheckResult(
                "table3_nrmse", method, transforms.PPSWOR, p, path,
                PASS if got <= tol else FAIL,
                {"row": [p, alpha, power], "measured": got,
                 "golden": golden, "tolerance": tol, "chi2_factor": factor,
                 "fp32_floor": floor, "trials": trials,
                 "worst_margin": float(got - tol)}))
    return results


# ---------------------------------------------------------------------------
# suite runner
# ---------------------------------------------------------------------------

CELL_CHECKS = (check_inclusion_probabilities, check_ht_unbiased,
               check_ht_ks, check_wor_distinct, check_wor_beats_wr,
               check_tv_single_draw)


def run_cell(name: str, scheme: str, p: float, path: str,
             cfg: ConformanceConfig) -> list:
    """All named checks for one (sampler, scheme, p, path) cell, sharing
    one trial ensemble."""
    data = prepare_cell(name, scheme, p, path, cfg)
    return [chk(name, scheme, p, path, cfg, data=data)
            for chk in CELL_CHECKS]


def run_suite(samplers: Optional[Sequence[str]] = None,
              schemes: Sequence[str] = SCHEMES,
              ps: Sequence[float] = (1.0,),
              paths: Sequence[str] = empirics.PATHS,
              cfg: ConformanceConfig = ConformanceConfig(),
              table3_trials: int = 0,
              codecs: Sequence[str] = ()) -> dict:
    """Sweep the grid and build the JSON report.

    ``table3_trials > 0`` additionally runs the Table-3 golden-value check
    with that many randomizations (the expensive, n=10^4 rows), on
    ``cfg.device``.  ``codecs`` must be empty until the codec axis is
    ported (``CODEC_ITEM``).
    """
    if codecs:
        raise NotImplementedError(
            f"codec-axis cells {list(codecs)} are not ported yet; they come "
            f"with {CODEC_ITEM}")
    samplers = list(samplers if samplers is not None else available())
    results = []
    for name in samplers:
        for scheme in schemes:
            for p in ps:
                for path in paths:
                    results.extend(run_cell(name, scheme, p, path, cfg))
    if table3_trials:
        results.extend(check_table3_nrmse(trials=table3_trials,
                                          delta=cfg.delta,
                                          device=cfg.device))
    meta = {"suite": "repro_torch.validate", "config": cfg._asdict(),
            "device": str(resolve_device(cfg.device)),
            "samplers": samplers, "schemes": list(schemes),
            "ps": list(ps), "paths": list(paths),
            "codecs": list(codecs), "table3_trials": table3_trials}
    return build(results, meta)
