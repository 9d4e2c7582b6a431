"""Port parity of the sampler registry: two-pass WORp (the ``worp.twopass_*``
functions, the ``twopass`` sampler and the engine's ``freeze`` /
``update_pass2`` / ``sample_exact``), the perfect oracles and the
``perfect`` sampler, and the TV cascade (``tv_sampler`` and the ``tv``
sampler), against the JAX package on the same numpy inputs.

Tolerances: seeds and seed bundles bit for bit; buffer keys, candidate keys
and sample keys identical; exact frequencies bit for bit on integer-valued
data (their sums are exact in any order); tables within rtol 2e-5 and atol
2e-5 * max(1, max|want|) (the reference kernel tests' 2e-5, scaled, since
``-log``/``pow`` differ by a few ulps between the two CPU math libraries);
transformed frequencies within rtol 2e-5; ``successive_wor_probability``
within rtol 1e-12 (both in float64).  ``wr_sample`` cannot match JAX's
PRNG draws, so it is held to its distribution: each key's count within 5
sigma of k * |nu|^p / ||nu||_p^p.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import countsketch as jcs
from repro.core import perfect as jperfect
from repro.core import sampler as jsampler
from repro.core import tv_sampler as jtv
from repro.core import worp as jw
from repro.engine import EngineConfig as JCfg
from repro.engine import SketchEngine as JEngine
from repro.engine import engine as jengine
from repro_torch import convert
from repro_torch.core import countsketch as tcs
from repro_torch.core import perfect as tperfect
from repro_torch.core import sampler as tsampler
from repro_torch.core import tv_sampler as ttv
from repro_torch.core import worp as tw
from repro_torch.engine import (EngineConfig, SketchEngine,
                                derive_stream_seeds, sampler_config)
from repro_torch.engine import planes as tplanes

B = 3
SAMPLERS = ("onepass", "perfect", "tv", "twopass")
NEAR_2_32 = [0, 1, 77, 99, 2**31, 2**32 - 1, 2**32 - 77, 2**32 - 100,
             0x9E3779B9, 0xABCD1234]
EDGE_KEY = 17691050  # uniform01 == 1.0 under transform seed 0


# the reference's single-stream functions, vmapped over the streams and
# compiled once for the file
_J_TP_UPDATE = jax.jit(jax.vmap(jw.twopass_update))
_J_TP_MERGE = jax.jit(jax.vmap(jw.twopass_merge))
_J_TV_UPDATE = jax.jit(jax.vmap(lambda s, k, v: jtv.update(s, k, v, 1.0)))
_J_TV_MERGE = jax.jit(jax.vmap(jtv.merge))
_J_TV_DRAW = jax.jit(jax.vmap(lambda s: jtv.produce_sample(s, 3, 1.0)))


@functools.partial(jax.jit, static_argnames=("k", "p", "scheme"))
def _j_tp_samples(st, k, p, scheme):
    return (jax.vmap(lambda s: jw.twopass_sample(s, k, p, scheme))(st),
            jax.vmap(lambda s: jw.twopass_extended_sample(s, k, p,
                                                          scheme))(st))


_J_PPSWOR = jax.jit(jperfect.ppswor_sample, static_argnums=(1, 2, 4))


def _t(x):
    return torch.tensor(np.array(x))


def _cfg_kw(name, **kw):
    base = dict(num_streams=B, rows=5, width=256, candidates=32, capacity=32,
                p=1.0, seed=11, sampler=name, domain=400, num_samplers=3)
    base.update(kw)
    return base


def _engines(name, plane="sparse", flush=40, **kw):
    kw = _cfg_kw(name, **kw)
    return (JEngine(JCfg(**kw), plane=plane, flush_elems=flush),
            SketchEngine(EngineConfig(**kw), plane=plane, flush_elems=flush,
                         device="cpu"))


def _sparse(seed=0, n=120, domain=400):
    """Integer-valued positive frequencies, keys % 7 == 0 twenty times
    heavier: well separated, and exact in any summation order."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, domain, (B, n)).astype(np.int32)
    vals = np.round((rng.random((B, n)) + 0.5)
                    * (1 + (keys % 7 == 0) * 20)).astype(np.float32)
    return keys, vals


def _assert_close(got, want, rtol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    finite = want[np.isfinite(want)]
    top = float(np.abs(finite).max()) if finite.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, top))


def _assert_states(tstate, jstate, float_rtol=2e-5):
    """Leaf by leaf: integer leaves (keys, seeds) equal, float leaves
    (tables, priorities, exact frequencies) within the table tolerance."""
    got = convert.state_to_numpy(tstate)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype.kind == "f":
            _assert_close(g, w, float_rtol)
        else:
            assert np.array_equal(g, w)


def _assert_pass2(t2, j2):
    """Pass-II buffers: keys identical, exact frequencies bit for bit, the
    priorities (estimates from tables within tolerance) within it."""
    assert np.array_equal(t2.keys.numpy(), np.asarray(j2.keys))
    assert np.array_equal(t2.freqs.numpy(), np.asarray(j2.freqs))
    _assert_close(t2.priority.numpy(), np.asarray(j2.priority))
    assert np.array_equal(t2.seed_transform.numpy(),
                          np.asarray(j2.seed_transform).astype(np.int64))


def _assert_samples(ts, js, exact_freqs=False):
    assert np.array_equal(ts.keys.numpy(), np.asarray(js.keys))
    if exact_freqs:
        assert np.array_equal(ts.freqs.numpy(), np.asarray(js.freqs))
    else:
        _assert_close(ts.freqs.numpy(), np.asarray(js.freqs))
    _assert_close(ts.transformed.numpy(), np.asarray(js.transformed))
    np.testing.assert_allclose(ts.threshold.numpy(), np.asarray(js.threshold),
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def test_tv_seed_bundle_bitwise_near_2_32():
    """tv_sampler.init's uint32 bundle: arange(r) * 0x9E3779B9 + seed, the
    sketch seeds ^ 0xABCD1234, the rHH's seed + 77 and + 99 -- all wrap."""
    seeds = np.array(NEAR_2_32, np.uint32)
    got = ttv.init(4, 3, 16, 5, 3, 16, 5, _t(seeds.astype(np.int64)),
                   device="cpu")
    want = jax.vmap(lambda s: jtv.init(4, 3, 16, 5, 3, 16, 5, s))(
        jnp.asarray(seeds))
    _assert_states(got, want, float_rtol=0)
    assert got.sketches.table.shape == (len(seeds), 4, 3, 16)


def test_tv_spec_seed_fold_bitwise_near_2_32():
    """The tv spec folds both protocol seeds: seed_sketch ^ (seed_transform
    * 0x9E3779B9), in uint32."""
    ss = np.array(NEAR_2_32, np.uint32)
    st = ss[::-1].copy()
    cfg = dict(rows=3, width=16, candidates=5, num_samplers=2)
    got = tsampler.make_sampler("tv", tsampler.SamplerConfig(**cfg)).init(
        _t(ss.astype(np.int64)), _t(st.astype(np.int64)))
    jspec = jsampler.make_sampler("tv", jsampler.SamplerConfig(**cfg))
    want = jax.vmap(jspec.init)(jnp.asarray(ss), jnp.asarray(st))
    _assert_states(got, want, float_rtol=0)


@pytest.mark.parametrize("name", SAMPLERS)
def test_engine_initial_state_bitwise(name):
    kw = _cfg_kw(name, seed=2**32 - 3)
    got = SketchEngine(EngineConfig(**kw), device="cpu").state
    want = jengine.init_batched(JCfg(**kw))
    _assert_states(got, want, float_rtol=0)


# ---------------------------------------------------------------------------
# two-pass WORp (core)
# ---------------------------------------------------------------------------

def _frozen_sketch(seed=4, rows=5, width=64):
    """A (B, rows, width) pass-I sketch of integer-valued cells, the same
    table in both packages."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-40, 40, (B, rows, width)).astype(np.float32)
    sk_seeds = np.array([3, 2**32 - 1, 0x5EED], np.uint32)
    return (tcs.CountSketch(table=_t(table),
                            seed=_t(sk_seeds.astype(np.int64))),
            jcs.CountSketch(table=jnp.asarray(table),
                            seed=jnp.asarray(sk_seeds)))


def _twopass_pair(cap=16):
    seeds = np.array([7, 2**32 - 2, 123456], np.uint32)
    return (tw.twopass_init(cap, _t(seeds.astype(np.int64))),
            jax.vmap(lambda s: jw.twopass_init(cap, s))(jnp.asarray(seeds)))


def test_twopass_update_and_merge_match_reference():
    """Buffer keys and priorities identical, exact frequencies bit for bit
    (integer values); -1 keys are padding."""
    tsk, jsk = _frozen_sketch()
    ta, ja = _twopass_pair()
    tb, jb = _twopass_pair()
    upd = _J_TP_UPDATE
    for step in range(3):
        keys, vals = _sparse(seed=step, n=40, domain=60)
        keys[1, ::5] = -1
        ta = tw.twopass_update(ta, tsk, _t(keys), _t(vals))
        ja = upd(ja, jsk, jnp.asarray(keys), jnp.asarray(vals))
        tb = tw.twopass_update(tb, tsk, _t(keys[:, ::-1]), _t(vals))
        jb = upd(jb, jsk, jnp.asarray(keys[:, ::-1]), jnp.asarray(vals))
    _assert_states(ta, ja, float_rtol=0)
    _assert_states(tw.twopass_merge(ta, tb), _J_TP_MERGE(ja, jb),
                   float_rtol=0)
    prio = tcs.estimate(tsk, _t(keys))
    via_prio = tw.twopass_update_from_priorities(ta, _t(keys), _t(vals), prio)
    _assert_states(via_prio, upd(ja, jsk, jnp.asarray(keys),
                                 jnp.asarray(vals)), float_rtol=0)


def test_twopass_merge_rejects_seed_mismatch():
    a = tw.twopass_init(8, _t([1, 2]))
    with pytest.raises(ValueError, match="seed_transform"):
        tw.twopass_merge(a, tw.twopass_init(8, _t([1, 3])))


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("k", [3, 15])
def test_twopass_sample_and_extended_match_reference(k, p, scheme):
    tsk, jsk = _frozen_sketch(seed=9)
    ts, js = _twopass_pair()
    keys, vals = _sparse(seed=5, n=50, domain=40)
    if k == 15:  # underfull buffers: fewer than k + 1 stored keys
        keys[:, 10:] = -1
    ts = tw.twopass_update(ts, tsk, _t(keys), _t(vals))
    js = _J_TP_UPDATE(js, jsk, jnp.asarray(keys), jnp.asarray(vals))
    got = tw.twopass_sample(ts, k, p, scheme)
    want, (jcert, jtau) = _j_tp_samples(js, k, p, scheme)
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    assert np.array_equal(got.freqs.numpy(), np.asarray(want.freqs))
    _assert_close(got.transformed.numpy(), want.transformed)
    np.testing.assert_allclose(got.threshold.numpy(), want.threshold,
                               rtol=2e-5)
    cert, tau = tw.twopass_extended_sample(ts, k, p, scheme)
    assert np.array_equal(cert.numpy(), np.asarray(jcert))
    np.testing.assert_allclose(tau.numpy(), jtau, rtol=2e-5)
    with pytest.raises(ValueError, match="capacity"):
        tw.twopass_sample(ts, 16, p, scheme)


def test_twopass_sample_edge_key_is_inf_as_reference():
    """uniform01 == 1.0 (ROADMAP Queue 3): |nu*| = +inf for any nonzero
    exact frequency, in both packages."""
    st = tw.twopass_init(4, 0, device="cpu")
    st = tw.twopass_update_from_priorities(
        st, _t([EDGE_KEY, 5]), _t([3.0, 2.0]), _t([1.0, 2.0]))
    got = tw.twopass_sample(st, 1, 1.0)
    want = jax.jit(lambda: jw.twopass_sample(
        jw.twopass_update_from_priorities(
            jw.twopass_init(4, 0), jnp.asarray([EDGE_KEY, 5]),
            jnp.asarray([3.0, 2.0]), jnp.asarray([1.0, 2.0])), 1, 1.0))()
    assert int(got.keys[0]) == int(want.keys[0]) == EDGE_KEY
    assert float(got.transformed[0]) == float(want.transformed[0])
    assert abs(float(got.transformed[0])) == np.inf


# ---------------------------------------------------------------------------
# perfect oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
def test_ppswor_sample_matches_reference(p, scheme):
    rng = np.random.default_rng(int(p * 4))
    freqs = (rng.integers(-20, 60, (B, 300))
             * (rng.random((B, 300)) < 0.6)).astype(np.float32)
    seeds = np.array([0, 2**32 - 1, 0x5EED], np.uint32)
    got = tperfect.ppswor_sample(_t(freqs), 10, p,
                                 _t(seeds.astype(np.int64)), scheme)
    want = jax.vmap(lambda f, s: _J_PPSWOR(f, 10, p, s, scheme))(
        jnp.asarray(freqs), jnp.asarray(seeds))
    assert np.array_equal(got.freqs.numpy(), np.asarray(want.freqs))
    _assert_samples(got, want, exact_freqs=True)


def test_ppswor_sample_ties_take_the_lowest_keys():
    """Zero frequencies tie at |nu*| = 0: an underfull vector fills with the
    lowest zero keys, as lax.top_k does."""
    freqs = np.zeros(50, np.float32)
    freqs[[7, 30]] = [4.0, -9.0]
    got = tperfect.ppswor_sample(_t(freqs), 5, 1.0, 3)
    want = _J_PPSWOR(jnp.asarray(freqs), 5, 1.0, jnp.uint32(3), "ppswor")
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    assert got.keys.tolist()[2:] == [0, 1, 2]


@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
def test_successive_wor_probability_float64(p):
    rng = np.random.default_rng(3)
    freqs = rng.normal(size=200).astype(np.float32) * 10
    keys = rng.choice(200, 12, replace=False).astype(np.int32)
    with jax.enable_x64(True):
        want = float(jperfect.successive_wor_probability(
            jnp.asarray(freqs), jnp.asarray(keys), p))
    got = tperfect.successive_wor_probability(_t(freqs), _t(keys), p)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    batched = tperfect.successive_wor_probability(
        _t(np.stack([freqs, freqs])), _t(np.stack([keys, keys])), p)
    assert batched.shape == (2,) and float(batched[1]) == float(got)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_wr_sample_distribution(p):
    freqs = np.array([0, 5, -1, 0, 2.5, 10, 0.5], np.float32)
    g = torch.Generator().manual_seed(17)
    draws = tperfect.wr_sample(_t(freqs), 20_000, p, g)
    assert draws.dtype == torch.int32 and draws.shape == (20_000,)
    w = np.abs(freqs.astype(np.float64)) ** p
    prob = w / w.sum()
    counts = np.bincount(draws.numpy(), minlength=len(freqs))
    sigma = np.sqrt(20_000 * prob * (1 - prob))
    assert np.all(np.abs(counts - 20_000 * prob) <= 5 * sigma + 1e-9)
    assert counts[freqs == 0].sum() == 0


# ---------------------------------------------------------------------------
# TV cascade (core)
# ---------------------------------------------------------------------------

def _tv_pair(r=3, rows=5, width=128, C=24, seeds=(5, 2**32 - 9, 0xABCD)):
    seeds = np.array(seeds, np.uint32)
    return (ttv.init(r, rows, width, C, rows, width, C,
                     _t(seeds.astype(np.int64))),
            jax.vmap(lambda s: jtv.init(r, rows, width, C, rows, width, C,
                                        s))(jnp.asarray(seeds)))


def _tv_fed(steps=2, n=60, domain=200, **kw):
    ts, js = _tv_pair(**kw)
    upd = _J_TV_UPDATE
    for step in range(steps):
        keys, vals = _sparse(seed=20 + step, n=n, domain=domain)
        ts = ttv.update(ts, _t(keys), _t(vals), 1.0)
        js = upd(js, jnp.asarray(keys), jnp.asarray(vals))
    return ts, js


def test_tv_update_merge_and_sample_match_reference():
    """Tables within tolerance, candidates identical, and the cascade's
    sample keys identical on well-separated input."""
    ta, ja = _tv_fed()
    _assert_states(ta, ja)
    tb, jb = _tv_fed(steps=1)
    _assert_states(ttv.merge(ta, tb), _J_TV_MERGE(ja, jb))
    keys = ttv.produce_sample(ta, 3, 1.0)
    want = _J_TV_DRAW(ja)
    assert np.array_equal(keys.numpy(), np.asarray(want))
    assert (keys != -1).all()


def test_tv_draw_takes_the_first_nan_as_argmax():
    """jnp.argmax returns the first maximum and counts NaN as the maximum:
    a cascade table with NaN cells draws the first candidate whose
    estimate is NaN, in both packages (the uniform01 == 1.0 edge)."""
    ts, _ = _tv_fed(steps=1)
    table = ts.sketches.table.clone()
    table[:, 0, :, 5] = float("nan")  # every row: a NaN median
    table[1, 1, :, :7] = float("nan")
    ts = ts._replace(sketches=ts.sketches._replace(table=table))
    js = convert.state_to_numpy(ts)
    treedef = jax.tree_util.tree_structure(_tv_pair()[1])
    js = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in js])
    want = np.asarray(_J_TV_DRAW(js))
    got = ttv.produce_sample(ts, 3, 1.0)
    assert np.array_equal(got.numpy(), want)


def test_tv_subtraction_leaves_earlier_sketches_bitwise():
    """The cascade's subtraction feeds only the sketches j > i: the others
    keep every cell, a -0.0 included."""
    ts, _ = _tv_fed(steps=1)
    table = torch.full_like(ts.sketches.table, -0.0)
    before = table.clone()
    ttv._subtract_from_later(table, ts.sketches.seed, ts.transform_seeds,
                             _t([3, 4, 5]).to(torch.int32),
                             _t([0.0, 0.0, -2.0]).float(), 0, 1.0, "ppswor")
    same = table[:, :1].view(torch.int32) == before[:, :1].view(torch.int32)
    assert bool(same.all())
    assert (table[:, 1:] != before[:, 1:]).any()


# ---------------------------------------------------------------------------
# the registry's specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SAMPLERS)
def test_spec_functions_match_reference(name):
    """Every registered spec's init/update/merge/sample/estimate and, for
    the two-phase samplers, init2/update2/merge2/sample2, stream-batched in
    the port against the vmapped reference spec."""
    kw = _cfg_kw(name)
    tcfg, jcfg = EngineConfig(**kw), JCfg(**kw)
    tspec = tsampler.make_sampler(name, sampler_config(tcfg))
    jspec = jengine.engine_spec(jcfg)
    jops = jengine.batched_ops(jspec)
    ta = tspec.init(*derive_stream_seeds(tcfg, device="cpu"))
    ja = jops.init(*jengine.derive_stream_seeds(jcfg))
    tb, jb = ta, ja
    for step in range(2):
        keys, vals = _sparse(seed=30 + step)
        ta = tspec.update(ta, _t(keys), _t(vals))
        ja = jops.update(ja, jnp.asarray(keys), jnp.asarray(vals))
        tb = tspec.update(tb, _t(keys[:, ::-1]), _t(vals[:, ::-1]))
        jb = jops.update(jb, jnp.asarray(keys[:, ::-1]),
                         jnp.asarray(vals[:, ::-1]))
    _assert_states(ta, ja)
    tm, jm = tspec.merge(ta, tb), jops.merge(ja, jb)
    _assert_states(tm, jm)
    _assert_samples(tspec.sample(tm, 4), jops.sample(jm, k=4),
                    exact_freqs=name in ("perfect", "twopass"))
    _assert_close(tspec.estimate(tm, _t(keys)).numpy(),
                  jops.estimate(jm, jnp.asarray(keys)))
    assert tspec.two_phase == jspec.two_phase == (name in ("onepass",
                                                           "twopass"))
    if not tspec.two_phase:
        return
    t2, j2 = tspec.init2(tm), jops.init2(jm)
    _assert_states(t2, j2, float_rtol=0)
    t2 = tspec.update2(t2, tm, _t(keys), _t(vals))
    j2 = jops.update2(j2, jm, jnp.asarray(keys), jnp.asarray(vals))
    _assert_pass2(t2, j2)
    t2, j2 = tspec.merge2(t2, t2), jops.merge2(j2, j2)
    _assert_pass2(t2, j2)
    _assert_samples(tspec.sample2(t2, 4), jops.sample2(j2, k=4),
                    exact_freqs=True)


def test_perfect_sample_k_too_large_raises():
    spec = tsampler.make_sampler("perfect", tsampler.SamplerConfig(domain=8))
    with pytest.raises(ValueError, match="domain"):
        spec.sample(spec.init(1, 2, device="cpu"), 8)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", ["sparse", "dense"])
@pytest.mark.parametrize("name", SAMPLERS)
def test_engine_planes_match_reference(name, plane):
    """The same stream through the JAX engine and the port's: states within
    tolerance (candidate and buffer keys identical), samples identical,
    estimates close."""
    je, te = _engines(name, plane)
    keys, vals = _sparse(seed=1)
    for i in range(3):
        sl = slice(40 * i, 40 * i + 40)
        je.ingest(keys[:, sl], vals[:, sl])
        te.ingest(keys[:, sl], vals[:, sl])
    _assert_samples(te.sample(4), je.sample(4),
                    exact_freqs=name in ("perfect", "twopass"))
    _assert_states(te.state, je.state)
    _assert_close(te.estimate(keys[:, :9]).numpy(),
                  je.estimate(jnp.asarray(keys[:, :9])))


@pytest.mark.parametrize("name", SAMPLERS)
def test_sparse_plane_equals_dense_plane(name):
    _, sparse = _engines(name, "sparse")
    _, dense = _engines(name, "dense")
    keys, vals = _sparse(seed=2)
    keys[2, ::3] = -1  # padding slots are ignored by both planes
    for i in range(3):
        sl = slice(40 * i, 40 * i + 40)
        sparse.ingest(keys[:, sl], vals[:, sl])
        dense.ingest(keys[:, sl], vals[:, sl])
    a, b = sparse.sample(4), dense.sample(4)
    assert torch.equal(a.keys, b.keys)
    for x, y in zip(convert.state_to_numpy(sparse.state),
                    convert.state_to_numpy(dense.state)):
        if x.dtype.kind == "f":
            _assert_close(x, y)
        else:
            assert np.array_equal(x, y)


@pytest.mark.parametrize("name", ["onepass", "twopass"])
def test_engine_pass2_matches_reference(name):
    """freeze -> update_pass2 -> sample_exact: the exact frequencies of the
    sampled keys equal the stream's aggregated frequencies."""
    je, te = _engines(name)
    keys, vals = _sparse(seed=4)
    je.ingest(keys, vals)
    te.ingest(keys, vals)
    je.freeze()
    te.freeze()
    for i in range(2):
        sl = slice(60 * i, 60 * i + 60)
        je.update_pass2(keys[:, sl], vals[:, sl])
        te.update_pass2(keys[:, sl], vals[:, sl])
    _assert_pass2(te.pass2, je.pass2)
    got, want = te.sample_exact(6), je.sample_exact(6)
    _assert_samples(got, want, exact_freqs=True)
    for b in range(B):
        agg = np.bincount(keys[b], weights=vals[b], minlength=400)
        assert np.array_equal(got.freqs[b].numpy(),
                              agg[got.keys[b].numpy()].astype(np.float32))


def test_pass2_needs_freeze_and_a_two_phase_sampler():
    _, te = _engines("onepass")
    with pytest.raises(RuntimeError, match="freeze"):
        te.update_pass2(np.zeros((B, 1), np.int32), np.zeros((B, 1)))
    with pytest.raises(RuntimeError, match="freeze"):
        te.sample_exact(2)
    for name in ("perfect", "tv"):
        with pytest.raises(ValueError, match="no exact second pass"):
            _engines(name)[1].freeze()


@pytest.mark.parametrize("name", SAMPLERS)
def test_merge_with_collapse_and_sample_state_match_reference(name):
    kw = dict(shared_seeds=True)
    ja, ta = _engines(name, **kw)
    jb, tb = _engines(name, **kw)
    for seed, (j, t) in zip((5, 6), ((ja, ta), (jb, tb))):
        keys, vals = _sparse(seed=seed)
        j.ingest(keys, vals)
        t.ingest(keys, vals)
    ja.merge_with(jb)
    ta.merge_with(tb)
    _assert_states(ta.state, ja.state)
    jc, tc = ja.collapse(), ta.collapse()
    _assert_states(tc, jc)
    exact = name in ("perfect", "twopass")
    _assert_samples(ta.sample_state(tb.state, 4), ja.sample_state(jb.state, 4),
                    exact_freqs=exact)


@pytest.mark.parametrize("name", SAMPLERS)
def test_state_carried_across_packages(name):
    """A JAX engine's state carried into the port (and the port's back into
    JAX) round-trips leaf for leaf, and continued on the same stream gives
    the same samples."""
    je, te = _engines(name)
    je2, _ = _engines(name)
    keys, vals = _sparse(seed=8)
    je.ingest(keys[:, :60], vals[:, :60])
    je.flush()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(je.state)]
    kind = type(te.state)
    te.state = convert.state_from_numpy(kind, leaves, device="cpu")
    back = convert.state_to_numpy(te.state)
    assert all(a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
               for a, b in zip(back, leaves))
    je2.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(je.state),
        [jnp.asarray(x) for x in back])
    for eng in (je, te, je2):
        eng.ingest(keys[:, 60:], vals[:, 60:])
    want = je.sample(4)
    _assert_samples(te.sample(4), want,
                    exact_freqs=name in ("perfect", "twopass"))
    assert np.array_equal(np.asarray(je2.sample(4).keys),
                          np.asarray(want.keys))
    with pytest.raises(ValueError, match="too many leaves"):
        convert.state_from_numpy(kind, leaves + [leaves[0]], device="cpu")
    with pytest.raises(ValueError, match="too few leaves"):
        convert.state_from_numpy(kind, leaves[:-1], device="cpu")


# ---------------------------------------------------------------------------
# ports of the reference's ordering tests (tests/test_planes.py)
# ---------------------------------------------------------------------------

def _planes_cfg(name, **kw):
    base = dict(num_streams=B, rows=3, width=128, candidates=64,
                capacity=64, p=1.0, seed=11, sampler=name, domain=40,
                num_samplers=3)
    base.update(kw)
    return EngineConfig(**base)


@pytest.mark.parametrize("name", SAMPLERS)
def test_interleaved_equals_aggregated_oracle(name):
    """``update`` drains the pending ingest buffer BEFORE its batch, so
    ingest -> update -> sample equals the flushed order (sparse plane)."""
    cfg = _planes_cfg(name)
    keys, vals = _sparse(seed=10, n=60, domain=40)
    eng = SketchEngine(cfg, flush_elems=10_000, device="cpu")
    eng.ingest(keys[:, :20], vals[:, :20])       # stays buffered
    eng.update(keys[:, 20:40], vals[:, 20:40])
    eng.ingest(keys[:, 40:], vals[:, 40:])
    s1 = eng.sample(4)
    agg = SketchEngine(cfg, device="cpu")
    agg.ingest(keys[:, :20], vals[:, :20])
    agg.flush()
    agg.update(keys[:, 20:40], vals[:, 20:40])
    agg.ingest(keys[:, 40:], vals[:, 40:])
    s2 = agg.sample(4)
    assert torch.equal(s1.keys, s2.keys)
    assert torch.equal(s1.freqs, s2.freqs)
    assert torch.equal(s1.threshold.isnan(), s2.threshold.isnan())
    assert torch.equal(torch.nan_to_num(s1.threshold),
                       torch.nan_to_num(s2.threshold))


def test_update_drains_buffer_first_regression():
    """The streaming two-pass buffer keys by online priorities read at
    batch time, so the order matters: the engine drains first, equal to
    the explicit flush-then-update, and the reverse order differs."""
    cfg = _planes_cfg("twopass", capacity=8, candidates=8)
    rng = np.random.default_rng(11)
    k1 = rng.integers(0, 40, (B, 30)).astype(np.int32)
    v1 = (rng.random((B, 30)).astype(np.float32) + 0.5) * 30   # heavy
    k2 = rng.integers(0, 40, (B, 30)).astype(np.int32)
    v2 = rng.random((B, 30)).astype(np.float32) + 0.5          # light

    eng = SketchEngine(cfg, flush_elems=10_000, device="cpu")
    eng.ingest(k1, v1)
    eng.update(k2, v2)
    good = SketchEngine(cfg, device="cpu")
    good.ingest(k1, v1)
    good.flush()
    good.update(k2, v2)
    bad = SketchEngine(cfg, device="cpu")       # the broken ordering
    bad.update(k2, v2)
    bad.ingest(k1, v1)
    bad.flush()
    got = convert.state_to_numpy(eng.state)
    assert all(np.array_equal(a, b) for a, b in
               zip(got, convert.state_to_numpy(good.state)))
    assert not all(np.array_equal(a, b) for a, b in
                   zip(got, convert.state_to_numpy(bad.state))), \
        "ordering discriminator too weak: reorder the data"


def test_frozen_sketch_registry():
    assert set(tplanes._FROZEN_SKETCH) == {"onepass", "twopass"}
    assert tplanes.frozen_sketch_getter("tv") is None
    _, te = _engines("twopass")
    assert te._frozen_sketch() is te.state.pass1.sketch


@pytest.mark.parametrize("name", SAMPLERS)
def test_samplers_default_to_the_card(name, monkeypatch):
    """Every sampler's engine and spec put their state on the card when no
    device is given, and raise without one instead of running on the
    CPU."""
    kw = _cfg_kw(name)
    spec = tsampler.make_sampler(name, sampler_config(EngineConfig(**kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SketchEngine(EngineConfig(**kw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.init(3, 4)
    st = spec.init(3, 4, device="cpu")
    assert {leaf.device.type for leaf in
            jax.tree_util.tree_leaves(st)} == {"cpu"}
