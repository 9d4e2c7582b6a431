"""The port's conformance harness (``repro_torch.validate``) against the JAX
package's (``repro.validate``), on the CPU.

* ``bounds``: every function returns the reference's value bit for bit on
  the same seeded numpy inputs.
* ``report``: a JSON report written by one package loads in the other, and
  both render the same summary line and markdown.
* ``empirics``: ``zipf_freqs`` and the trial seeds bit for bit; the trial
  runners on the same seeds give identical sample keys, frequencies within
  the reference's scale-aware bound rtol 1e-4 / atol 1e-5 * max(1,
  max|want|) (float sums in another order), and the oracle's transformed
  frequencies within 4 ulps (``exp1``/``pow``).
* ``conformance``: for every sampler, both schemes, p = 1, on the dense and
  ingest planes, the port's cells have the reference's statuses, and their
  numeric details agree within rtol 1e-4 / atol 1e-5 (the KS statistic
  within 2 / trials: a rounding difference may swap two pooled points);
  ``wor_beats_wr``'s WR side draws from another generator, so it is held
  to its status only.
* The harness can fail (seed reuse, top-k off by one, a duplicated key, a
  biased plane), and the cross-package KS cell: the port's ingest plane
  against the reference's dense plane under disjoint seed banks, within
  ``bounds.two_sample_ks_radius``.
* The port's grid over every plane at p = 1 (the full grid is ``deep``),
  its CLI, and no worker thread outliving a cell.
"""
import ast
import itertools
import math
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.validate import bounds as jbounds
from repro.validate import conformance as JC
from repro.validate import empirics as JE
from repro.validate import report as jreport
from repro_torch.core import transforms
from repro_torch.core.perfect import Sample
from repro_torch.core.sampler import available
from repro_torch.engine import planes as P
from repro_torch.validate import bounds, empirics, report
from repro_torch.validate import conformance as C
from repro_torch.validate import __main__ as cli

jax.config.update("jax_platform_name", "cpu")

SCHEMES = ["ppswor", "priority"]
CFG_FAST = C.ConformanceConfig(trials=128, ref_trials=384, device="cpu")
CFG_DEEP = C.ConformanceConfig(trials=384, ref_trials=1152, device="cpu")
# the reference's cells at the port's parity operating point
PARITY = dict(trials=96, ref_trials=288)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the test workers
    share the host's cores, and intra-op threads spinning on an
    oversubscribed host made a cell 10-60x slower than alone."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_value(a, b):
    """The same Python or numpy value, bit for bit."""
    if isinstance(a, (float, int, bool)) or isinstance(b, (float, int, bool)):
        return type(a) is type(b) and (a == b or (a != a and b != b)) \
            and (not isinstance(a, float)
                 or math.copysign(1, a) == math.copysign(1, b))
    return _bits_equal(a, b)


# ---------------------------------------------------------------------------
# bounds: bit for bit
# ---------------------------------------------------------------------------

def _bounds_inputs():
    rng = np.random.default_rng(7)
    T, n = 48, 96
    tstar = rng.standard_exponential((T, n)) ** -1.0 * rng.choice(
        [-1.0, 1.0], (T, n))
    tstar = tstar.astype(np.float32)
    thr = np.sort(np.abs(tstar), axis=1)[:, -9].astype(np.float32)
    freqs = (rng.pareto(1.5, n) * 10).astype(np.float32)
    phat = rng.random(n)
    return dict(T=T, n=n, tstar=tstar, thr=thr, freqs=freqs, phat=phat,
                q=rng.random(n) * 0.3)


BOUNDS_CALLS = {
    "normal_quantile": lambda b, x: [b.normal_quantile(q) for q in
                                     (1e-6, 0.025, 0.5, 0.9995)],
    "hoeffding_radius": lambda b, x: [b.hoeffding_radius(t, d, s) for t, d, s
                                      in ((10, 1e-3, 1), (384, 1e-3, 96),
                                          (1152, 5e-4, 7))],
    "bernstein_radius": lambda b, x: b.bernstein_radius(x["phat"], 384, 1e-3,
                                                        96),
    "binomial_radius": lambda b, x: b.binomial_radius(x["phat"], 128, 1e-3,
                                                      96),
    "two_sample_radius": lambda b, x: b.two_sample_radius(
        x["phat"], 128, x["phat"][::-1], 384, 1e-3, support=96),
    "clt_mean_radius": lambda b, x: [b.clt_mean_radius(s, t, d) for s, t, d
                                     in ((1.0, 8, 1e-3), (37.5, 384, 5e-4))],
    "chi2_quantile": lambda b, x: [b.chi2_quantile(df, q) for df, q in
                                   ((10, 0.95), (12, 1e-4), (40, 0.9999))],
    "nrmse_upper_factor": lambda b, x: [b.nrmse_upper_factor(t, 1e-3 / 15)
                                        for t in (8, 12, 24)],
    "nrmse_lower_factor": lambda b, x: [b.nrmse_lower_factor(t, 1e-3 / 15)
                                        for t in (8, 40)],
    "dkw_radius": lambda b, x: [b.dkw_radius(t, 1e-3) for t in (96, 384)],
    "two_sample_ks_radius": lambda b, x: b.two_sample_ks_radius(384, 128,
                                                                1e-3),
    "sign_test_min_wins": lambda b, x: [b.sign_test_min_wins(t, d) for t, d
                                        in ((96, 1e-3), (384, 1e-6))],
    "median_flip_bound": lambda b, x: b.median_flip_bound(x["q"], 5),
    "countsketch_flip_probability": lambda b, x:
        b.countsketch_flip_probability(x["tstar"], x["thr"], 248, 5),
    "sketch_bias_allowance": lambda b, x: b.sketch_bias_allowance(
        1234.5, 8, 248),
    "fp32_nrmse_floor": lambda b, x: b.fp32_nrmse_floor(100),
    "quantization_step": lambda b, x: b.quantization_step(
        np.abs(x["tstar"]).max(1), 1 / 127),
    "clamp_excess": lambda b, x: [b._clamp_excess(np.abs(x["tstar"]), c)
                                  for c in (None, 2.0)],
    "quantization_flip_allowance": lambda b, x: [
        b.quantization_flip_allowance(x["tstar"], x["thr"], r, shards=2,
                                      clamp=c)
        for r, c in ((1 / 127, None), (2.0 ** -11, 3.0), (0.5, None))],
    "quantization_ht_allowance": lambda b, x: [
        b.quantization_ht_allowance(x["freqs"], x["tstar"], x["thr"], r,
                                    shards=2, clamp=c, power=pw)
        for r, c, pw in ((1 / 127, None, 1.0), (2.0 ** -11, 3.0, 2.0))],
    "quantization_nrmse_allowance": lambda b, x: [
        b.quantization_nrmse_allowance(r, 100, 2) for r in (0.0, 1 / 127)],
    "codec_admissible": lambda b, x: [b.codec_admissible(f, r) for f, r in
                                      ((0.1, 0.2), (0.5, 0.1), (0.2, 1.0))],
}


@pytest.mark.parametrize("name", sorted(BOUNDS_CALLS))
def test_bounds_bitwise(name):
    x = _bounds_inputs()
    got = BOUNDS_CALLS[name](bounds, x)
    want = BOUNDS_CALLS[name](jbounds, x)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same_value(g, w), f"{name}: {g!r} vs {w!r}"


def test_bounds_cover_the_reference():
    """Every public function of the reference's bounds is here, and held
    above (``_clamp_excess`` under its own name)."""
    ref = {n for n, v in vars(jbounds).items()
           if callable(v) and getattr(v, "__module__", "") == jbounds.__name__}
    port = {n for n, v in vars(bounds).items()
            if callable(v) and getattr(v, "__module__", "") == bounds.__name__}
    assert port == ref
    held = set(BOUNDS_CALLS) | {"_clamp_excess"}
    assert ref - {"_clamp_excess"} <= held


# ---------------------------------------------------------------------------
# report: one schema
# ---------------------------------------------------------------------------

def _results(mod):
    return [mod.CheckResult("c1", "onepass", "ppswor", 1.0, "dense",
                            mod.PASS, {"worst_margin": -0.5}),
            mod.CheckResult("c2", "tv", "ppswor", 1.0, "ingest", mod.SKIP,
                            {"reason": "n/a"}),
            mod.CheckResult("c3", "twopass", "priority", 2.0, "dense",
                            mod.FAIL, {"worst_margin": np.float64(0.2),
                                       "t": torch.tensor(3.5)})]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_report_roundtrip_across_packages(writer, tmp_path):
    src, dst = (report, jreport) if writer == "port" else (jreport, report)
    rep = src.build(_results(src), meta={"trials": np.int64(7)})
    path = src.write(rep, str(tmp_path / "r.json"))
    back = dst.load(path)
    assert back["summary"] == {"passed": 1, "failed": 1, "skipped": 1,
                               "total": 3}
    assert not dst.ok(back)
    assert dst.summary_line(back) == src.summary_line(rep) == \
        "conformance_summary,passed=1,failed=1,skipped=1,total=3"
    assert len(dst.failures(back)) == 1
    assert report.format_markdown(back) == jreport.format_markdown(back)


def test_report_build_matches_reference():
    import json

    want = jreport.build(_results(jreport)[:2], meta={"a": np.float32(1.5)})
    got = report.build(_results(report)[:2], meta={"a": np.float32(1.5)})
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


# ---------------------------------------------------------------------------
# empirics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,alpha,seed", [(96, 2.0, 0x0F), (10_000, 1.0, 10),
                                          (64, 1.5, 3)])
def test_zipf_freqs_bitwise(n, alpha, seed):
    assert _bits_equal(empirics.zipf_freqs(n, alpha, seed),
                       JE.zipf_freqs(n, alpha, seed))


@pytest.mark.parametrize("trials,seed,offset", [(384, 0xC0F, 0),
                                                (1152, 0xC0F, 1 << 20),
                                                (12, 0x7AB3, 2 << 20)])
def test_trial_seeds_bitwise(trials, seed, offset):
    got = empirics.derive_trial_seeds(trials, seed, offset, device="cpu")
    want = JE.derive_trial_seeds(trials, seed, offset)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_paths_cover_plane_registry():
    want = tuple("ingest" if n == "sparse" else n
                 for n in P.available_planes())
    assert empirics.PATHS == want == ("dense", "ingest", "async", "pipeline")
    assert set(empirics.PATHS) <= set(JE.PATHS)


def _assert_freqs_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got)), what
    atol = ATOL * max(1.0, float(np.abs(want[finite]).max(initial=0)))
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name,scheme,path", list(itertools.product(
    ["onepass", "perfect", "tv", "twopass"], SCHEMES, ["dense", "ingest"])))
def test_run_trials_matches_reference(name, scheme, path):
    # the parity cells' trial count: the reference's compiled updates serve
    # both tests
    trials = PARITY["trials"]
    freqs = JE.zipf_freqs(96, 2.0, seed=3)
    got, _ = empirics.run_trials(
        empirics.spec_for(name, 96, 8, 1.0, scheme), freqs, 8, trials,
        seed=5, path=path, device="cpu")
    want, _ = JE.run_trials(JE.spec_for(name, 96, 8, 1.0, scheme), freqs, 8,
                            trials, seed=5, path=path)
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    _assert_freqs_close(got.freqs.numpy(), want.freqs, f"{name} freqs")
    _assert_freqs_close(got.threshold.numpy(), want.threshold,
                        f"{name} threshold")


@pytest.mark.parametrize("scheme,p", list(itertools.product(SCHEMES,
                                                            [0.5, 1.0, 2.0])))
def test_perfect_trials_match_reference(scheme, p):
    freqs = JE.zipf_freqs(96, 2.0, seed=3)
    got, tstar, thr = empirics.perfect_trials(freqs, 8, p, scheme, 64, 5,
                                              offset=1 << 20, device="cpu")
    want, wtstar, wthr = JE.perfect_trials(freqs, 8, p, scheme, 64, 5,
                                           offset=1 << 20)
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    assert tstar.dtype == wtstar.dtype == np.float32
    ulps = np.abs(tstar.view(np.int32).astype(np.int64)
                  - wtstar.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4, f"tstar differs by {ulps.max()} ulps"
    assert np.abs(thr.view(np.int32).astype(np.int64)
                  - wthr.view(np.int32).astype(np.int64)).max() <= 4


def test_ht_estimates_match_reference():
    freqs = JE.zipf_freqs(64, 2.0, seed=3)
    got, _ = empirics.run_trials(
        empirics.spec_for("onepass", 64, 4, 1.0, "ppswor"), freqs, 4, 16,
        seed=5, path="ingest", device="cpu")
    want, _ = JE.run_trials(JE.spec_for("onepass", 64, 4, 1.0, "ppswor"),
                            freqs, 4, 16, seed=5, path="ingest")
    for power in (1.0, 2.0, 3.0):
        g = empirics.ht_estimates(got, 1.0, lambda w: torch.abs(w) ** power)
        w = JE.ht_estimates(want, 1.0, lambda x: jnp.abs(x) ** power)
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_wr_moment_estimates_agree_in_distribution():
    """Other draws (a torch generator against a JAX key), one distribution:
    the two (T,) WR ensembles pass the two-sample KS radius, and one seed
    gives the same draws twice."""
    freqs = JE.zipf_freqs(96, 2.0, seed=3)
    got = empirics.wr_moment_estimates(freqs, 8, 1.0, 3.0, 384, 11,
                                       device="cpu")
    again = empirics.wr_moment_estimates(freqs, 8, 1.0, 3.0, 384, 11,
                                         device="cpu")
    want = JE.wr_moment_estimates(freqs, 8, 1.0, 3.0, 384, 11)
    assert np.array_equal(got, again)
    assert empirics.ks_statistic(got, want) <= \
        bounds.two_sample_ks_radius(384, 384, 1e-3)


def test_async_path_bitwise_matches_ingest():
    freqs = empirics.zipf_freqs(64, 2.0, seed=3)
    spec = empirics.spec_for("onepass", 64, 4, 1.0, transforms.PPSWOR)
    si, sti = empirics.run_trials(spec, freqs, 4, 16, seed=5,
                                  path=empirics.INGEST, device="cpu")
    sa, sta = empirics.run_trials(spec, freqs, 4, 16, seed=5,
                                  path=empirics.ASYNC, device="cpu")
    for a, b in zip(list(si) + P._leaves(sti), list(sa) + P._leaves(sta)):
        assert _bits_equal(a.numpy(), b.numpy())


def test_run_trials_rejects_unknown_path_and_codec():
    spec = empirics.spec_for("onepass", 16, 2, 1.0, "ppswor")
    with pytest.raises(ValueError, match="unknown trial path"):
        empirics.run_trials(spec, np.ones(16), 2, 4, 0, path="fleet",
                            device="cpu")
    with pytest.raises(NotImplementedError, match="codec"):
        empirics.run_trials(spec, np.ones(16), 2, 4, 0, codec="q8",
                            device="cpu")


# ---------------------------------------------------------------------------
# conformance: the reference's statuses and details
# ---------------------------------------------------------------------------

def _close(got, want, path, key):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {set(got) ^ set(want)}"
        for k in want:
            _close(got[k], want[k], f"{path}.{k}", k)
    elif isinstance(want, str):
        assert got == want, path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", key)
    else:
        atol = 2.0 / PARITY["trials"] if key == "ks" else ATOL
        assert float(got) == pytest.approx(float(want), rel=RTOL, abs=atol), \
            f"{path}: {got} vs {want}"


@pytest.mark.parametrize("name,scheme,path", list(itertools.product(
    ["onepass", "perfect", "tv", "twopass"], SCHEMES, ["dense", "ingest"])))
def test_cell_matches_reference(name, scheme, path):
    got = C.run_cell(name, scheme, 1.0, path,
                     C.ConformanceConfig(device="cpu", **PARITY))
    want = JC.run_cell(name, scheme, 1.0, path,
                       JC.ConformanceConfig(**PARITY))
    assert [r.status for r in got] == [r.status for r in want]
    assert any(r.status == report.PASS for r in got)
    for g, w in zip(got, want):
        assert g[:6] == w[:6]
        gd, wd = g.to_dict()["details"], w.to_dict()["details"]
        if g.check == "wor_beats_wr" and g.status != report.SKIP:
            # the WR draws differ (another generator): status only
            for k in ("wins", "worst_margin", "nrmse_wr"):
                gd.pop(k), wd.pop(k)
        _close(gd, wd, f"{g.check}", "")


@pytest.mark.parametrize("name,scheme", list(itertools.product(
    ["onepass", "perfect", "twopass"], SCHEMES)))
def test_cross_package_ks(name, scheme):
    """The distributional gate: the port's ingest plane (kernel path)
    against the reference's dense plane, disjoint seed banks, within the
    pure two-sample DKW radius."""
    cfg = CFG_FAST
    freqs = empirics.zipf_freqs(cfg.n, cfg.alpha, seed=cfg.seed & 0xFF)
    got, _ = empirics.run_trials(
        empirics.spec_for(name, cfg.n, cfg.k, 1.0, scheme), freqs, cfg.k,
        cfg.trials, cfg.seed, path=empirics.INGEST, device="cpu")
    want, _ = JE.run_trials(JE.spec_for(name, cfg.n, cfg.k, 1.0, scheme),
                            freqs, cfg.k, cfg.trials, cfg.seed,
                            path=JE.DENSE, offset=2 * cfg.ref_offset)
    est = empirics.ht_estimates(got, 1.0, torch.abs, scheme)
    ref = JE.ht_estimates(want, 1.0, jnp.abs, scheme)
    ks = empirics.ks_statistic(est, ref)
    assert ks <= bounds.two_sample_ks_radius(cfg.trials, cfg.trials,
                                             cfg.delta), ks


def _grid():
    """Tier 1 runs the p = 1 slice, but for the tv cascade on the pipeline
    plane (8 s a cell on the CPU, whose plain scatter hashes each shard's
    512-slot padding; ``test_cli_fast_on_cpu`` runs that cell at 96
    trials); the rest is ``deep``."""
    params = []
    for name, scheme, p, path in itertools.product(
            available(), C.SCHEMES, C.PS, empirics.PATHS):
        fast = p == 1.0 and not (name == "tv" and path == "pipeline")
        marks = () if fast else (pytest.mark.deep,)
        params.append(pytest.param(name, scheme, p, path, marks=marks,
                                   id=f"{name}-{scheme}-p{p:g}-{path}"))
    return params


@pytest.mark.parametrize("name,scheme,p,path", _grid())
def test_port_cell(name, scheme, p, path, request):
    """The port's grid on every plane (``_grid`` says which cells are
    tier 1); ``deep`` cells at the nightly trial counts."""
    deep = request.node.get_closest_marker("deep") is not None
    before = threading.active_count()
    results = C.run_cell(name, scheme, p, path, CFG_DEEP if deep
                         else CFG_FAST)
    failed = [r for r in results if r.status == report.FAIL]
    assert not failed, "\n".join(f"{r.check}: {r.details}" for r in failed)
    assert any(r.status == report.PASS for r in results)
    assert threading.active_count() <= before, "a plane's thread survived"


def test_skips_are_only_where_documented():
    tiny = C.ConformanceConfig(trials=16, ref_trials=32, device="cpu")
    for name in available():
        rs = C.run_cell(name, transforms.PPSWOR, 1.0, empirics.DENSE, tiny)
        skipped = {r.check for r in rs if r.status == report.SKIP}
        if name == "tv":
            assert skipped == {"inclusion_probabilities", "ht_unbiased",
                               "ht_ks", "wor_beats_wr"}
        else:
            assert skipped <= {"tv_single_draw", "wor_beats_wr"}


def test_caches_are_keyed_by_device(monkeypatch):
    """An ensemble computed on one device never serves a cell on another:
    the oracle and KS caches key on the config, which carries it."""
    calls = []

    def perfect_trials(*a, device=None, **k):
        calls.append(("oracle", device))
        return None, None, None

    def run_trials(*a, device=None, **k):
        calls.append(("ks", device))
        return None, None

    monkeypatch.setattr(empirics, "perfect_trials", perfect_trials)
    monkeypatch.setattr(empirics, "run_trials", run_trials)
    monkeypatch.setattr(C, "_REF_CACHE", {})
    monkeypatch.setattr(C, "_KS_REF_CACHE", {})
    spec = empirics.spec_for("onepass", 96, 8, 1.0, "ppswor")
    for device in ("cpu", "cuda", "cpu"):
        cfg = CFG_FAST._replace(device=device)
        C._reference(None, 1.0, "ppswor", cfg)
        C._ks_reference("onepass", "ppswor", 1.0, cfg, spec)
    assert calls == [("oracle", "cpu"), ("ks", "cpu"), ("oracle", "cuda"),
                     ("ks", "cuda")]


def test_codec_axis_not_ported():
    with pytest.raises(NotImplementedError, match="item 6"):
        C.run_suite(samplers=["perfect"], paths=["dense"], codecs=["q8"],
                    cfg=CFG_FAST)
    with pytest.raises(NotImplementedError, match="item 6"):
        C.prepare_cell("onepass", "ppswor", 1.0, "pipeline",
                       CFG_FAST._replace(codec="fp16"))


@pytest.mark.parametrize("rows", [[(1.0, 2.0, 3.0)]])
def test_table3_single_row(rows):
    """One Table-3 row against the paper's golden values, on the CPU, and
    the golden values equal the benchmark's."""
    from benchmarks.table3_nrmse import PAPER, ROWS
    from repro_torch.validate import table3

    assert table3.ROWS == ROWS and table3.PAPER == PAPER
    results = C.check_table3_nrmse(trials=8, rows=rows, device="cpu")
    assert len(results) == 3
    for r in results:
        assert r.status == report.PASS, r.details


@pytest.mark.deep
def test_table3_all_rows():
    results = C.check_table3_nrmse(trials=24, device="cpu")
    bad = [r for r in results if r.status != report.PASS]
    assert not bad, "\n".join(f"{r.sampler}: {r.details}" for r in bad)


class TestHarnessCanFail:
    """Negative controls on the port: each broken sampler wraps the exact
    oracle spec, so a failure is a distributional detection."""

    def _base(self, cfg):
        return empirics.spec_for("perfect", cfg.n, cfg.k, 1.0,
                                 transforms.PPSWOR)

    def test_seed_reuse_fails_inclusion(self):
        base = self._base(CFG_FAST)
        broken = base._replace(
            init=lambda ss, ts: base.init(ss, torch.full_like(ts, 0xDEAD)))
        r = C.check_inclusion_probabilities(
            "perfect", transforms.PPSWOR, 1.0, empirics.DENSE, CFG_FAST,
            spec=broken)
        assert r.status == report.FAIL
        assert r.details["worst_margin"] > 0

    def test_topk_off_by_one_fails_inclusion(self):
        base = self._base(CFG_FAST)

        def sample(st, k):
            s = base.sample(st, k + 1)
            return Sample(keys=s.keys[..., 1:], freqs=s.freqs[..., 1:],
                          threshold=s.threshold,
                          transformed=s.transformed[..., 1:])

        r = C.check_inclusion_probabilities(
            "perfect", transforms.PPSWOR, 1.0, empirics.DENSE, CFG_FAST,
            spec=base._replace(sample=sample))
        assert r.status == report.FAIL

    def test_duplicated_key_fails_distinct(self):
        base = self._base(CFG_FAST)

        def sample(st, k):
            s = base.sample(st, k)
            keys = s.keys.clone()
            keys[..., -1] = keys[..., 0]  # replacement!
            return s._replace(keys=keys)

        r = C.check_wor_distinct("perfect", transforms.PPSWOR, 1.0,
                                 empirics.DENSE, CFG_FAST,
                                 spec=base._replace(sample=sample))
        assert r.status == report.FAIL

    @pytest.mark.parametrize("path", ["ingest", "async", "pipeline"])
    def test_biased_plane_fails_ht_ks(self, path):
        base = self._base(CFG_FAST)
        biased = base._replace(
            update=lambda st, k, v: base.update(st, k, v * 1.25))
        data = C.prepare_cell("perfect", transforms.PPSWOR, 1.0, path,
                              CFG_FAST, spec=biased)
        data = data._replace(spec=base)  # the reference plane is clean
        r = C.check_ht_ks("perfect", transforms.PPSWOR, 1.0, path,
                          CFG_FAST, spec=base, data=data)
        assert r.status == report.FAIL
        assert r.details["worst_margin"] > 0


# ---------------------------------------------------------------------------
# suite and CLI
# ---------------------------------------------------------------------------

def test_suite_report_shape():
    cfg = C.ConformanceConfig(trials=48, ref_trials=96, device="cpu")
    rep = C.run_suite(samplers=["perfect"], schemes=[transforms.PPSWOR],
                      ps=[1.0], paths=[empirics.DENSE], cfg=cfg)
    assert rep["summary"]["failed"] == 0
    assert rep["summary"]["total"] == len(C.CELL_CHECKS)
    assert rep["meta"]["samplers"] == ["perfect"]
    assert rep["meta"]["device"] == "cpu"


def test_cli_fast_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.validate --fast --device cpu`` exits 0 over
    every sampler, both schemes and every plane, and its report loads in
    the reference's module; no plane's thread outlives it."""
    before = threading.active_count()
    out = tmp_path / "rep.json"
    assert cli.main(["--fast", "--device", "cpu", "--report", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    rep = jreport.load(str(out))
    assert jreport.ok(rep)
    assert jreport.summary_line(rep) in lines
    assert rep["meta"]["paths"] == list(empirics.PATHS)
    assert sum(ln.startswith("conformance_check,") for ln in lines) \
        == rep["summary"]["total"] == 4 * 2 * 4 * len(C.CELL_CHECKS)
    assert threading.active_count() <= before


def test_cli_codecs_default_empty_and_rejected():
    args = ["--fast", "--device", "cpu", "--samplers", "perfect",
            "--paths", "dense", "--codecs", "q8"]
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(args)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("sub", ["validate", "data"])
def test_no_jax_or_reference_imports(sub):
    for path in sorted((PKG / sub).glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                    f"{path.name} imports {name}"
