"""The paper's runners on the port (``repro_torch.paper``) against the
reference's (``benchmarks/``), on the CPU, at small sizes (n = 2000, k =
20, 3 Table 3 runs).

Both draw the WOR samples from the same hashed seeds: perfect p-ppswor,
1-pass and 2-pass WORp must give identical sample keys, and the estimates
built on them agree within rtol 1e-5 (the tables and transforms differ by
the backends' ulps).  Figure 2's relative errors and Figure 1's WOR tail
mass agree within 1e-5.  Appendix B.1's simulation is numpy in both, so
its rows are equal.  The WR draws come from a ``torch.Generator`` in the
port and a JAX PRNG key in the reference: only their NRMSE over 100 draws
is compared, within a factor of 2 (both below 1e-6 where the estimator is
exact, power = p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as ref_common
from benchmarks import fig2_rankfreq as ref_fig2
from benchmarks import psi_calibration as ref_psi
from benchmarks import table3_nrmse as ref_t3
from repro.core import estimators as jest
from repro.core import perfect as jperfect
from repro.core import worp as jworp
from repro_torch.core import estimators
from repro_torch.paper import common, fig1_wor_vs_wr, fig2_rankfreq
from repro_torch.paper import psi_calibration, table3_nrmse
from repro_torch.paper import __main__ as paper_main
from repro_torch.validate import table3

jax.config.update("jax_platform_name", "cpu")

N, K, RUNS = 2000, 20, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _keys(s):
    return sorted(np.asarray(s.keys).tolist())


def test_zipf_freqs_equal_reference():
    for alpha, seed in ((1.0, 1), (2.0, 20)):
        np.testing.assert_array_equal(common.zipf_freqs(N, alpha, seed),
                                      ref_common.zipf_freqs(N, alpha, seed))


def test_table3_rows_are_the_validate_copy():
    assert table3_nrmse.ROWS is table3.ROWS
    assert table3_nrmse.PAPER is table3.PAPER
    assert table3_nrmse.ROWS == ref_t3.ROWS and table3_nrmse.PAPER == \
        ref_t3.PAPER


@pytest.fixture(scope="module")
def table3_estimates():
    est = {}
    table3_nrmse.run(n=N, k=K, runs=RUNS, verbose=False, device="cpu",
                     estimates=est)
    return est


@pytest.mark.parametrize("row", range(5))
def test_table3_samples_and_estimates_match_reference(row, table3_estimates):
    p, alpha, power = table3.ROWS[row]
    est = table3_estimates
    freqs = common.zipf_freqs(N, alpha, seed=int(alpha * 10))
    fj = jnp.asarray(freqs)
    for t in range(RUNS):
        seed_t = 5000 + t
        got = table3_nrmse.run_samples(freqs, K, p, seed_t, "cpu")
        want = {
            "wor": jperfect.ppswor_sample(fj, K, p, seed_t),
            "one": jworp.onepass_sample(
                ref_common.one_pass_state(freqs, K, p, seed_t), K, p),
            "two": ref_common.two_pass_sample(freqs, K, p, seed_t)}
        for m in ("wor", "one", "two"):
            assert _keys(got[m]) == _keys(want[m]), (row, t, m)
            w = float(jest.frequency_moment(want[m], p, power))
            np.testing.assert_allclose(est[(p, alpha, power)][m][t], w,
                                       rtol=1e-5, err_msg=f"{row} {t} {m}")


@pytest.mark.parametrize("row", range(5))
def test_table3_wr_nrmse_within_factor_two(row):
    p, alpha, power = table3.ROWS[row]
    freqs = common.zipf_freqs(N, alpha, seed=int(alpha * 10))
    truth = float((np.abs(freqs).astype(np.float64) ** power).sum())
    draws = 100
    got = [table3_nrmse.wr_moment(freqs, K, p, power,
                                  torch.Generator().manual_seed(t))
           for t in range(draws)]
    want = [ref_t3._wr_moment(freqs, K, p, power, jax.random.PRNGKey(t))
            for t in range(draws)]
    ng = estimators.nrmse(np.array(got), truth)
    nw = jest.nrmse(np.array(want), truth)
    if power == p:
        assert ng < 1e-6 and nw < 1e-6, (ng, nw)
    else:
        assert 0.5 <= ng / nw <= 2.0, (ng, nw)


def test_fig2_relative_errors_match_reference():
    errors = {}
    fig2_rankfreq.run(n=N, k=K, verbose=False, device="cpu", errors=errors)
    for (p, alpha), errs in errors.items():
        freqs = ref_common.zipf_freqs(N, alpha, seed=31)
        true_sorted = np.sort(np.abs(freqs))[::-1]
        seed_t = 424242
        samples = {
            "wor": jperfect.ppswor_sample(jnp.asarray(freqs), K, p, seed_t),
            "one": jworp.onepass_sample(
                ref_common.one_pass_state(freqs, K, p, seed_t), K, p),
            "two": ref_common.two_pass_sample(freqs, K, p, seed_t)}
        for m, s in samples.items():
            mags, ranks = ref_fig2._rank_curve(s, p)
            want = ref_fig2._err_at_ranks(mags, ranks, true_sorted,
                                          fig2_rankfreq.PROBE)
            np.testing.assert_allclose(errs[m], want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{p} {alpha} {m}")


def test_fig1_wor_tail_mass_matches_reference():
    freqs = common.zipf_freqs(N, 2.0, seed=2)
    order = np.argsort(-np.abs(freqs))
    for t in range(RUNS):
        got = fig1_wor_vs_wr.tail_mass_wor(freqs, K, 2.0, 7000 + t,
                                           order[:100], "cpu")
        s = jperfect.ppswor_sample(jnp.asarray(freqs), K, 2.0, 7000 + t)
        in_tail = ~jnp.isin(s.keys, jnp.asarray(order[:100]))
        probs = jest.inclusion_probability(s.freqs, s.threshold, 2.0)
        want = float(jnp.sum(jnp.where(
            in_tail, jnp.abs(s.freqs) / jnp.maximum(probs, 1e-30), 0.0)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fig1_rows_shape():
    rows = fig1_wor_vs_wr.run(n=N, verbose=False, device="cpu")
    assert [r[0] for r in rows] == [
        f"fig1_effsize_zipf{a:g}_k{k}" for a in (1.0, 2.0)
        for k in (10, 100, 1000)] + ["fig1_tailmass_zipf2_l2"]
    for name, _, derived in rows[:-1]:
        wr = float(derived.split()[0].split("=")[1])
        k = int(name.rsplit("_k", 1)[1])
        assert 1 <= wr <= k


def test_psi_rows_equal_reference():
    got = psi_calibration.run(n=N, verbose=False)
    want = ref_psi.run(n=N, verbose=False)
    assert [(r[0], r[2]) for r in got] == [(r[0], r[2]) for r in want]


def test_main_on_cpu_prints_every_section(capsys, monkeypatch):
    monkeypatch.setattr(table3_nrmse, "run",
                        lambda **kw: [("table3_x", 1.0, "wr=0")] * 5)
    monkeypatch.setattr(fig1_wor_vs_wr, "run", lambda **kw: [("fig1_x", 1.0,
                                                             "d")])
    monkeypatch.setattr(fig2_rankfreq, "run", lambda **kw: [("fig2_x", 1.0,
                                                            "d")])
    monkeypatch.setattr(psi_calibration, "run", lambda **kw: [("psi_x", 1.0,
                                                              "d")])
    rows = paper_main.main(["--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(rows) == 8 and "== 8 paper rows done ==" in out
    assert "table3_x,1.00,wr=0" in out and "psi_x,1.00,d" in out


def test_runners_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table3_nrmse.run(n=N, k=K, runs=1, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig2_rankfreq.run(n=N, k=K, verbose=False)
