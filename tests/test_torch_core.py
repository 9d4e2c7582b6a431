"""Port parity: transforms, CountSketch, one-pass WORp and the sampler
registry of ``repro_torch`` against the JAX reference, on the same numpy
inputs.  Hash-derived reads (estimates from one table) must agree bit for
bit; sums of many floats (tables) agree to float32 summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import countsketch as jcs
from repro.core import transforms as jtr
from repro.core import worp as jw
from repro_torch.core import countsketch as tcs
from repro_torch.core import sampler as tsampler
from repro_torch.core import transforms as ttr
from repro_torch.core import worp as tw
from repro_torch.engine import EngineConfig
from repro_torch.engine import engine as tengine


def _t(x):
    return torch.from_numpy(np.array(x))


def _stream(seed, n=400, hi=3000):
    rng = np.random.default_rng(seed)
    keys = rng.zipf(1.3, n).clip(max=hi).astype(np.int32)
    vals = rng.choice([1.0, -1.0, 2.5], n).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
def test_transform_and_invert_match_reference(scheme, p):
    """Eq. 5 / Eq. 6: the randomizer is hash-exact; -log and pow may differ
    by a few float32 ulps between the two CPU math libraries."""
    rng = np.random.default_rng(int(p * 10))
    keys = rng.integers(-2**31, 2**31 - 1, 300).astype(np.int32)
    vals = rng.normal(size=300).astype(np.float32)
    seed = 2**31 + 99
    want = np.asarray(jtr.transform_values(jnp.asarray(keys),
                                           jnp.asarray(vals), p,
                                           jnp.uint32(seed), scheme))
    got = ttr.transform_values(_t(keys), _t(vals), p, seed, scheme).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)
    back_want = np.asarray(jtr.invert_frequency(
        jnp.asarray(keys), jnp.asarray(want), p, jnp.uint32(seed), scheme))
    back = ttr.invert_frequency(_t(keys), _t(want), p, seed, scheme).numpy()
    np.testing.assert_allclose(back, back_want, rtol=2e-6)
    np.testing.assert_allclose(back, vals, rtol=1e-4)


@pytest.mark.parametrize("p", [0.7, 1.0, 1.5])
def test_transform_bits_do_not_depend_on_thread_count(p):
    """The CPU transform gives the same bits under 1 and 3 torch threads:
    the intra-op split must not move an ulp (a float32 ``torch.pow`` did,
    in 1-3 of these 2.1 M elements)."""
    rng = np.random.default_rng(0)
    B, n = 8, 262_147
    keys = _t(rng.integers(-2**31, 2**31 - 1, (B, n)).astype(np.int32))
    vals = _t(rng.normal(size=(B, n)).astype(np.float32))
    seeds = torch.arange(B, dtype=torch.int64)[:, None] * 7919 + 12345
    threads = torch.get_num_threads()
    try:
        bits = []
        for t in (1, 3):
            torch.set_num_threads(t)
            bits.append(ttr.transform_values(keys, vals, p, seeds).view(
                torch.int32))
    finally:
        torch.set_num_threads(threads)
    assert int((bits[0] != bits[1]).sum()) == 0


def test_randomizer_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="unknown bottom-k scheme"):
        ttr.randomizer(torch.tensor([1]), 0, "bogus")


@pytest.mark.parametrize("rows", [5, 6, 7])
def test_median_has_jnp_semantics(rows):
    """jnp.median averages the two middle values for an even count (where
    torch.median takes the lower one) and is NaN on any NaN."""
    rng = np.random.default_rng(rows)
    x = rng.integers(-3, 4, (4, rows, 50)).astype(np.float32)  # many ties
    x[0, 0, 0] = np.nan
    want = np.asarray(jnp.median(jnp.asarray(x), axis=1))
    got = tcs.median(_t(x), 1).numpy()
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("rows,width", [(5, 384), (6, 1000)])
def test_countsketch_update_estimate_match_reference(rows, width):
    keys, vals = _stream(rows)
    seed = 2**31 + 5
    jsk = jcs.update(jcs.init(rows, width, seed), jnp.asarray(keys),
                     jnp.asarray(vals))
    tsk = tcs.update(tcs.init(rows, width, seed, device="cpu"), _t(keys),
                     _t(vals))
    np.testing.assert_allclose(tsk.table.numpy(), np.asarray(jsk.table),
                               rtol=2e-5, atol=2e-5)
    # estimates read the SAME table in both packages: bit for bit
    q = np.concatenate([keys[:50], [-1, 0, 2**31 - 1]]).astype(np.int32)
    same = tcs.CountSketch(table=_t(np.asarray(jsk.table)), seed=tsk.seed)
    assert np.array_equal(tcs.estimate(same, _t(q)).numpy(),
                          np.asarray(jcs.estimate(jsk, jnp.asarray(q))))


def test_countsketch_batched_equals_per_stream():
    """A leading stream axis gives what one call per stream gives."""
    seeds = torch.tensor([3, 2**32 - 1, 17], dtype=torch.int64)
    keys = torch.stack([_t(_stream(s, 200)[0]) for s in range(3)])
    vals = torch.stack([_t(_stream(s, 200)[1]) for s in range(3)])
    batched = tcs.update(tcs.init(6, 384, seeds), keys, vals)
    for b in range(3):
        one = tcs.update(tcs.init(6, 384, int(seeds[b]), device="cpu"),
                         keys[b], vals[b])
        assert torch.equal(batched.table[b], one.table)
        assert torch.equal(tcs.estimate(batched, keys)[b],
                           tcs.estimate(one, keys[b]))


def test_countsketch_merge_and_seed_check():
    k, v = _stream(1)
    a = tcs.update(tcs.init(5, 384, 9, device="cpu"), _t(k), _t(v))
    b = tcs.update(tcs.init(5, 384, 9, device="cpu"), _t(k), -_t(v))
    assert not tcs.merge(a, b).table.abs().max() > 1e-3
    with pytest.raises(ValueError, match="different hash seeds"):
        tcs.merge(a, tcs.init(5, 384, 10, device="cpu"))


@pytest.mark.parametrize("k", [1, 8, 64])
def test_l2_error_bound_matches_reference(k):
    rng = np.random.default_rng(k)
    table = rng.normal(size=(6, 384)).astype(np.float32)
    table[:, :3] *= 100.0
    want = float(jcs.l2_error_bound(
        jcs.CountSketch(jnp.asarray(table), jnp.uint32(1)), k))
    got = float(tcs.l2_error_bound(
        tcs.CountSketch(_t(table), torch.tensor(1)), k))
    # row_l2 is a difference of two float32 sums that cancels the heavy
    # buckets' mass, so summation order shows at a few ulps of that mass
    mass = float((table.astype(np.float64) ** 2).sum(1).max())
    atol = 16 * np.finfo(np.float32).eps * mass / table.shape[1]
    assert got ** 2 == pytest.approx(want ** 2, rel=0, abs=atol)


def test_top_k_matches_lax_ties_and_neg_inf():
    x = np.array([5, -np.inf, 5, -np.inf, 1, 5], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = tw.top_k(_t(x), 5)
    assert got_i.tolist() == np.asarray(want_i).tolist() == [0, 2, 5, 4, 1]
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("case", range(4))
def test_dedup_topc_matches_reference(case):
    """Duplicate keys, -1 padding, tied and -inf priorities, batched over B:
    the kept keys, their order and priorities equal the reference's."""
    rng = np.random.default_rng(case)
    B, n, cap = 3, 40, 12
    keys = rng.integers(-1, 15, (B, n)).astype(np.int32)
    vals = rng.integers(-3, 4, (B, n)).astype(np.float32)
    prio_of_key = rng.integers(0, 4, 16).astype(np.float32)  # many ties
    prio_of_key[rng.integers(0, 16)] = -np.inf
    prio = prio_of_key[keys + 1]
    tk, tv, tp = tw._dedup_topc(_t(keys), _t(vals), _t(prio), cap)
    for b in range(B):
        jk, jv, jp = jw._dedup_topc(jnp.asarray(keys[b]), jnp.asarray(vals[b]),
                                    jnp.asarray(prio[b]), cap)
        assert tk[b].tolist() == np.asarray(jk).tolist()
        assert np.array_equal(tv[b].numpy(), np.asarray(jv))
        assert np.array_equal(tp[b].numpy(), np.asarray(jp))


@pytest.mark.parametrize("case", range(6))
def test_dedup_keys_topc_matches_reference(case):
    """The refresh's keys-only dedup keeps the keys, in the order and with
    the priorities, that the reference's valued dedup keeps on zero values:
    duplicate keys, -1 padding, a row all padding, tied, -inf and NaN
    priorities, batched over B; cases 3-5 ask for more slots than there
    are distinct keys."""
    rng = np.random.default_rng(100 + case)
    B, n = 4, 40
    cap = 12 if case < 3 else 24     # keys -1..14: 15 distinct live keys
    keys = rng.integers(-1, 15, (B, n)).astype(np.int32)
    keys[B - 1] = -1
    prio_of_key = rng.integers(0, 4, 16).astype(np.float32)  # many ties
    prio_of_key[rng.choice(np.arange(1, 16), 2, replace=False)] = [
        -np.inf, np.nan]
    prio = prio_of_key[keys + 1]
    tk, tp = tw._dedup_keys_topc(_t(keys), _t(prio), cap)
    assert tk.shape == tp.shape == (B, cap)
    for b in range(B):
        jk, _, jp = jw._dedup_topc(jnp.asarray(keys[b]),
                                   jnp.zeros(n, jnp.float32),
                                   jnp.asarray(prio[b]), cap)
        assert tk[b].tolist() == np.asarray(jk).tolist()
        np.testing.assert_array_equal(tp[b].numpy(), np.asarray(jp))
    assert tk[B - 1].tolist() == [-1] * cap


def _jax_sketch(sk, b):
    return jcs.CountSketch(jnp.asarray(sk.table[b].numpy()),
                           jnp.uint32(int(sk.seed[b])))


@pytest.mark.parametrize("base,lengths", [
    ([0, 10, 2**31], [300, 125, 0]),
    ([2**32 - 100, 7, 2**31 - 5], [300, 299, 40]),
])
def test_refresh_candidates_match_reference_at_a_padded_dense_shape(
        base, lengths):
    """Two dense steps through ``engine.onepass_update_dense`` (the second
    over candidates that repeat its keys), and ``worp.refresh_candidates``
    on the same sketch: the candidate keys equal the reference's
    ``refresh_candidates`` on that sketch, stream by stream."""
    cfg = EngineConfig(num_streams=3, rows=5, width=384, candidates=32)
    st = tengine.onepass_init_batched(cfg, device="cpu")
    rng = np.random.default_rng(len(base) + lengths[-1])
    n = 300
    offs = np.arange(n, dtype=np.int64)
    dense = np.where(offs < np.array(lengths)[:, None],
                     ((np.array(base)[:, None] + offs) % 2**32)
                     .astype(np.uint32).view(np.int32), -1).astype(np.int32)
    for _ in range(2):
        vals = rng.normal(size=(3, n)).astype(np.float32)
        new = tengine.onepass_update_dense(
            st, _t(vals), 1.0, base_keys=torch.tensor(base),
            lengths=torch.tensor(lengths))
        port = tw.refresh_candidates(new.sketch, st.cand_keys, _t(dense))
        assert torch.equal(port, new.cand_keys)
        for b in range(3):
            want = jw.refresh_candidates(_jax_sketch(new.sketch, b),
                                         jnp.asarray(st.cand_keys[b].numpy()),
                                         jnp.asarray(dense[b]))
            assert new.cand_keys[b].tolist() == np.asarray(want).tolist()
        st = new
    assert (st.cand_keys != -1).sum(1).tolist() == [min(32, m)
                                                    for m in lengths]


class _Summed(Exception):
    pass


def test_candidate_refresh_sums_nothing(monkeypatch):
    """The refresh keeps keys alone: with ``worp.segment_sum`` made to
    raise, a one-pass update, a dense update and both merges run, while
    pass II, whose values are exact frequencies, still sums."""
    def segment_sum(values, seg):
        raise _Summed

    monkeypatch.setattr(tw, "segment_sum", segment_sum)
    k, v = _stream(3, 200)
    a = tw.onepass_update(tw.onepass_init(5, 384, 16, 1, 2, device="cpu"),
                          _t(k), _t(v), 1.0)
    tw.onepass_merge(a, a)
    cfg = EngineConfig(num_streams=2, rows=5, width=384, candidates=16)
    st = tengine.onepass_update_dense(
        tengine.onepass_init_batched(cfg, device="cpu"),
        torch.ones(2, 100), 1.0, lengths=[100, 60])
    tengine.onepass_merge_batched(st, st)
    with pytest.raises(_Summed):
        tw.twopass_update(tw.twopass_init(16, 2, device="cpu"), a.sketch,
                          _t(k), _t(v))


def _jax_state(st):
    return jw.OnePassState(
        sketch=jcs.CountSketch(jnp.asarray(st.sketch.table.numpy()),
                               jnp.uint32(int(st.sketch.seed))),
        cand_keys=jnp.asarray(st.cand_keys.numpy()),
        seed_transform=jnp.uint32(int(st.seed_transform)))


@pytest.mark.parametrize("k", [1, 5, 9])
def test_sample_from_estimates_ties_and_underfull(k):
    """Underfull candidate buffers (-1 slots) and tied estimates: the port
    picks the same slots, threshold and zeroed padding as the reference."""
    st = tw.onepass_init(5, 384, 10, 3, 2**31 + 1, device="cpu")
    cand = torch.tensor([4, -1, 7, 9, -1, 11, -1, 2, -1, -1], dtype=torch.int32)
    st = st._replace(cand_keys=cand)
    est = torch.tensor([2.0, 9.0, -2.0, 2.0, 1.0, 0.5, 3.0, -7.0, 0.0, 2.0])
    got = tw.onepass_sample_from_estimates(st, est, k, 1.0)
    want = jw.onepass_sample_from_estimates(_jax_state(st),
                                            jnp.asarray(est.numpy()), k, 1.0)
    assert got.keys.tolist() == np.asarray(want.keys).tolist()
    assert float(got.threshold) == float(want.threshold)
    assert np.array_equal(got.transformed.numpy(),
                          np.asarray(want.transformed))
    np.testing.assert_allclose(got.freqs.numpy(), np.asarray(want.freqs),
                               rtol=2e-6)


def test_sample_k_too_large_raises():
    st = tw.onepass_init(5, 384, 10, 3, 4, device="cpu")
    with pytest.raises(ValueError, match="needs k < candidates"):
        tw.onepass_sample(st, 10, 1.0)


@pytest.mark.parametrize("scheme,p", [("ppswor", 1.0), ("priority", 0.5),
                                      ("ppswor", 2.0)])
def test_onepass_update_merge_sample_match_reference(scheme, p):
    rows, width, C, k = 6, 1000, 32, 8
    ka, va = _stream(1)
    kb, vb = _stream(2)
    js = [jw.onepass_update(jw.onepass_init(rows, width, C, 11, 2**31 + 3),
                            jnp.asarray(kk), jnp.asarray(vv), p, scheme)
          for kk, vv in ((ka, va), (kb, vb))]
    ts = [tw.onepass_update(tw.onepass_init(rows, width, C, 11, 2**31 + 3,
                                            device="cpu"),
                            _t(kk), _t(vv), p, scheme)
          for kk, vv in ((ka, va), (kb, vb))]
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t.sketch.table.numpy(),
                                   np.asarray(j.sketch.table), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(j.sketch.table).max())))
        assert t.cand_keys.tolist() == np.asarray(j.cand_keys).tolist()
    jm, tm = jw.onepass_merge(*js), tw.onepass_merge(*ts)
    assert tm.cand_keys.tolist() == np.asarray(jm.cand_keys).tolist()
    jsamp = jw.onepass_sample(jm, k, p, scheme)
    tsamp = tw.onepass_sample(tm, k, p, scheme)
    assert tsamp.keys.tolist() == np.asarray(jsamp.keys).tolist()
    np.testing.assert_allclose(tsamp.freqs.numpy(), np.asarray(jsamp.freqs),
                               rtol=1e-4)
    assert bool(tw.failure_test(tm.sketch, tsamp, k, p)) == bool(
        jw.failure_test(jm.sketch, jsamp, k, p))


def test_onepass_merge_rejects_seed_mismatch():
    a = tw.onepass_init(5, 384, 8, 1, 2, device="cpu")
    b = tw.onepass_init(5, 384, 8, 1, 3, device="cpu")
    with pytest.raises(ValueError, match="different seed_transform"):
        tw.onepass_merge(a, b)


def test_sampler_registry():
    cfg = tsampler.SamplerConfig(rows=5, width=384, candidates=16)
    spec = tsampler.make_sampler("onepass", cfg)
    assert spec is tsampler.make_sampler("onepass", cfg)
    assert tsampler.available() == ("onepass", "perfect", "tv", "twopass")
    assert spec.two_phase
    with pytest.raises(KeyError, match="unknown sampler"):
        tsampler.make_sampler("nope", cfg)
    k, v = _stream(5, 100)
    st = spec.update(spec.init(torch.tensor([1, 2]), torch.tensor([3, 4])),
                     torch.stack([_t(k), _t(k)]), torch.stack([_t(v), _t(v)]))
    assert st.sketch.table.shape == (2, 5, 384)
    samp = spec.sample(st, 4)
    assert samp.keys.shape == (2, 4) and samp.threshold.shape == (2,)
    est = spec.estimate(st, st.cand_keys)
    assert est.shape == (2, 16)


def test_core_entry_points_default_to_the_card(monkeypatch):
    """With no device, plain seeds put the state on the card, and without
    a card the entry points raise instead of running on the CPU; a tensor
    seed keeps its own device."""
    spec = tsampler.make_sampler("onepass", tsampler.SamplerConfig(
        rows=5, width=384, candidates=16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for init in (lambda: tcs.init(5, 384, 3),
                 lambda: tw.onepass_init(5, 384, 10, 3, 4),
                 lambda: spec.init(3, 4),
                 lambda: spec.init(torch.tensor([3]), 4, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init()
    seeds = torch.tensor([3, 2**32 - 1])
    for st in (tw.onepass_init(5, 384, 10, seeds, 4),
               spec.init(seeds, torch.tensor([4, 5])),
               spec.init(3, 4, device="cpu")):
        assert {t.device.type for t in (st.sketch.table, st.sketch.seed,
                                         st.cand_keys, st.seed_transform)} \
            == {"cpu"}
    assert tcs.init(5, 384, seeds).table.device.type == "cpu"
