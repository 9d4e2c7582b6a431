"""The port's ingest pipeline, ``ZipfStream`` and ``FrequencySketcher``
against the JAX package's, on the CPU.

* ``ZipfStream.batch_at`` and ``ShardedSource``'s shard split are the
  reference's bit for bit; ``PackedBatcher``'s concatenated live events
  equal the reference's (its span follows the port's tiling, so the blocks
  differ; the event sequence does not).
* ``PrefetchingFeeder``: the fan-in is producer-timing-free, so a threaded
  feed into the port's async plane is bit for bit its sparse plane's and
  the synchronous reference's; packing preserves the dense plane's tables
  (rtol 1e-4 / atol 1e-5 * max(1, max|want|), the reference's scale-aware
  bound) and samples; the per-shard collapse is within that bound; the
  port's fan-in matches the JAX package's fan-in within it, with the same
  sample keys.
* Backpressure, a producer's error surfacing at the drain, ``close()``
  unblocking stalled producers.  Every wait is bounded.
* ``FrequencySketcher``: state within the bound and sample keys identical
  to the reference's, through the plain path and the scatter kernel's.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.data import ingest_pipeline as JI
from repro.data import pipeline as JD
from repro_torch import convert
from repro_torch.data import ingest_pipeline as I
from repro_torch.data import pipeline as D
from repro_torch.data.ingest_pipeline import (PackedBatcher,
                                              PrefetchingFeeder,
                                              ShardedSource)
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.engine.engine import onepass_sample_batched
from repro_torch.kernels import tiling

jax.config.update("jax_platform_name", "cpu")

B = 3
WAIT_S = 10.0  # the longest any test waits for a producer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the test workers
    share the host's cores, and intra-op threads spinning on an
    oversubscribed host made a cell 10-60x slower than alone."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfg(**kw):
    base = dict(num_streams=B, rows=3, width=128, candidates=64, capacity=64,
                p=1.0, seed=11, sampler="onepass", domain=4096,
                num_samplers=3)
    base.update(kw)
    return base


def _engine(plane="sparse", **kw):
    return SketchEngine(EngineConfig(**_cfg()), plane=plane, flush_elems=1,
                        device="cpu", **kw)


def _stream(seed=7):
    return D.TurnstileZipfStream(vocab_size=2000, alpha=1.2, seed=seed)


def _events(nsteps=10, n=220):
    return list(_stream().event_iterator(n, nsteps=nsteps))


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.dtype, x.shape, x.view(np.uint8).tobytes()


def _leaves_equal(a, b):
    la, lb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return len(la) == len(lb) and all(_bits(x) == _bits(y)
                                      for x, y in zip(la, lb))


def _assert_table_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _blocks(batcher_cls, evs, shards, block_elems, streams):
    src = (ShardedSource if batcher_cls is PackedBatcher
           else JI.ShardedSource)(evs, num_shards=shards)
    per = []
    for s in range(shards):
        b = batcher_cls(block_elems, streams=streams)
        blks = []
        for k, v in src.shard_events(s):
            blks += b.add(k, v)
        tail = b.flush_tail()
        if tail is not None:
            blks.append(tail)
        per.append(blks)
    return per


def _round_robin(per):
    done, idx, out = [False] * len(per), [0] * len(per), []
    while not all(done):
        for s in range(len(per)):
            if done[s]:
                continue
            if idx[s] < len(per[s]):
                out.append(per[s][idx[s]])
                idx[s] += 1
            else:
                done[s] = True
    return out


# ---------------------------------------------------------------------------
# streams and sharding: the reference's bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard", [(0, 0), (3, 1), (17, 5)])
def test_zipf_batch_at_bitwise(step, shard):
    got = D.ZipfStream(50_000, 1.2, 9).batch_at(step, shard, 4, 33)
    want = JD.ZipfStream(50_000, 1.2, 9).batch_at(step, shard, 4, 33)
    assert _bits(got) == _bits(want)


def test_zipf_lm_batch_and_iterator():
    z = D.ZipfStream(1000, 1.5, 3)
    got = z.lm_batch(2, 1, 4, 16, device="cpu")
    want = JD.ZipfStream(1000, 1.5, 3).lm_batch(2, 1, 4, 16)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        assert got[key].device.type == "cpu"
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
    it = z.iterator(1, 4, 16, start_step=2, device="cpu")
    assert torch.equal(next(it)["tokens"], got["tokens"])
    assert not torch.equal(next(it)["tokens"], got["tokens"])


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_sharded_source_split_bitwise(num_shards):
    stream = _stream()
    src = ShardedSource.from_turnstile(stream, n=256, num_shards=num_shards,
                                       nsteps=5)
    jsrc = JI.ShardedSource.from_turnstile(
        JD.TurnstileZipfStream(2000, 1.2, 7), n=256, num_shards=num_shards,
        nsteps=5)
    for s in range(num_shards):
        got, want = list(src.shard_events(s)), list(jsrc.shard_events(s))
        assert len(got) == len(want) == 5
        for (k, v), (wk, wv) in zip(got, want):
            assert _bits(k) == _bits(wk) and _bits(v) == _bits(wv)


def test_sharded_source_validates():
    with pytest.raises(ValueError, match="num_shards"):
        ShardedSource([], num_shards=0)
    with pytest.raises(ValueError, match="out of range"):
        next(ShardedSource([], num_shards=2).shard_events(2))


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_elems", [1, 300, 1024, 4096, 5000])
def test_span_is_port_tiling_quantized(block_elems):
    b = PackedBatcher(block_elems=block_elems, streams=2)
    assert b.span == tiling.packed_span(block_elems)
    assert b.span % tiling.PACK_QUANTUM == 0
    assert b.span % tiling.TABLE_THREADS == 0
    assert b.span >= block_elems and b.span - block_elems < \
        tiling.PACK_QUANTUM


@pytest.mark.parametrize("shards,block_elems", [(1, 128), (3, 300),
                                                (4, 2048)])
def test_packed_events_equal_reference(shards, block_elems):
    """The concatenated live events of every shard's blocks equal the
    reference batcher's, in order (the spans differ)."""
    evs = _events(nsteps=12, n=700)
    got = _blocks(PackedBatcher, evs, shards, block_elems, 2)
    want = _blocks(JI.PackedBatcher, evs, shards, block_elems, 2)
    for g, w in zip(got, want):
        gk = np.concatenate([k[0] for k, _ in g]) if g else np.zeros(0)
        gv = np.concatenate([v[0] for _, v in g]) if g else np.zeros(0)
        wk = np.concatenate([k[0] for k, _ in w]) if w else np.zeros(0)
        wv = np.concatenate([v[0] for _, v in w]) if w else np.zeros(0)
        assert _bits(gk[gk != -1]) == _bits(wk[wk != -1])
        assert _bits(gv[gk != -1]) == _bits(wv[wk != -1])
        assert np.all(gv[gk == -1] == 0.0)


@pytest.mark.parametrize("plane", ["sparse", "async", "pipeline"])
def test_plane_joins_packed_blocks_c_contiguous(plane):
    """A plane's flush batch is C-contiguous even when it was fed the
    batcher's broadcast views (``np.concatenate`` follows its inputs'
    strides and would give a Fortran-ordered array, which the kernels
    refuse on the card)."""
    b = PackedBatcher(block_elems=1024, streams=B)
    (blk,) = b.add(np.arange(1024, dtype=np.int32),
                   np.ones(1024, np.float32))
    eng = SketchEngine(EngineConfig(**_cfg()), plane=plane,
                       flush_elems=4096, device="cpu")
    seen = []
    target = eng.plane._subplanes[0] if plane == "pipeline" else eng.plane
    apply = target._apply

    def spy(state, keys, vals):
        seen.append((keys.flags["C_CONTIGUOUS"], vals.flags["C_CONTIGUOUS"]))
        return apply(state, keys, vals)

    target._apply = spy
    eng.ingest(*blk)
    eng.ingest(blk[0][:, :7], blk[1][:, :7])
    eng.flush()
    assert seen and all(k and v for k, v in seen)
    eng.plane.close()


def test_blocks_fixed_shape_and_accounting():
    b = PackedBatcher(block_elems=128, streams=2)
    rng = np.random.default_rng(1)
    fed, out = [], []
    for size in (37, 2000, 5, 91, 2600, 1):
        k = rng.integers(0, 1 << 20, size).astype(np.int32)
        fed.append(k)
        out += b.add(k, np.ones(size, np.float32))
    tail = b.flush_tail()
    out += [tail] if tail is not None else []
    for bk, bv in out:
        assert bk.shape == bv.shape == (2, b.span)
        assert bk.dtype == np.int32 and bv.dtype == np.float32
    assert b.events == sum(k.size for k in fed)
    assert b.blocks == len(out)
    assert b.pad_slots == b.blocks * b.span - b.events
    assert b.pack_efficiency == b.events / (b.blocks * b.span)


def test_batcher_validates_and_full_blocks_do_not_pad():
    with pytest.raises(ValueError, match="block_elems"):
        PackedBatcher(block_elems=0)
    b = PackedBatcher(block_elems=64)
    with pytest.raises(ValueError, match="mismatch"):
        b.add(np.arange(3, dtype=np.int32), np.ones(4, np.float32))
    assert b.flush_tail() is None
    assert len(b.add(np.arange(2 * b.span, dtype=np.int32),
                     np.ones(2 * b.span, np.float32))) == 2
    assert b.flush_tail() is None and b.pad_slots == 0
    assert b.pack_efficiency == 1.0


# ---------------------------------------------------------------------------
# the feeder: fan-in determinism, packing, per-shard
# ---------------------------------------------------------------------------

def _sync_reference(evs, shards, block_elems=256):
    eng = _engine("sparse")
    for blk in _round_robin(_blocks(PackedBatcher, evs, shards, block_elems,
                                    B)):
        eng.ingest(*blk)
    return eng.flush()


@pytest.mark.parametrize("plane", ["sparse", "async"])
def test_fanin_bitwise_vs_sync_reference(plane):
    evs = _events()
    ref = _sync_reference(evs, shards=4)
    eng = _engine(plane)
    stats = PrefetchingFeeder(ShardedSource(evs, num_shards=4), eng,
                              block_elems=256, prefetch=2).run()
    assert stats.events == sum(k.size for k, _ in evs)
    assert _leaves_equal(eng.state, ref.state)
    assert np.array_equal(eng.sample(8).keys.numpy(),
                          ref.sample(8).keys.numpy())
    eng.plane.close()


def test_fanin_async_bitwise_vs_fanin_sparse():
    evs = _events(nsteps=8)
    engs = {}
    for plane in ("sparse", "async"):
        engs[plane] = _engine(plane)
        PrefetchingFeeder(ShardedSource(evs, num_shards=3), engs[plane],
                          block_elems=512, prefetch=1).run()
    assert _leaves_equal(engs["sparse"].state, engs["async"].state)
    sa, ss = engs["async"].sample(8), engs["sparse"].sample(8)
    assert all(_bits(a.numpy()) == _bits(b.numpy()) for a, b in zip(sa, ss))
    engs["async"].plane.close()


def _union_sample(st, other, k):
    """The one-pass sample of ``st``'s tables read over the union of both
    states' candidate buffers."""
    pool = torch.sort(torch.cat([st.cand_keys, other.cand_keys], 1),
                      1).values
    dup = torch.zeros_like(pool, dtype=torch.bool)
    dup[:, 1:] = pool[:, 1:] == pool[:, :-1]
    return onepass_sample_batched(
        st._replace(cand_keys=torch.where(dup, -1, pool)), k, 1.0)


def test_packing_preserves_dense_plane():
    """Packed + sharded + threaded is a pure re-batching: the same tables
    within the bound as the dense plane fed the raw ragged stream, and the
    same sample keys read over the union of both candidate buffers.  (The
    buffer is refreshed at each flush, so its content depends on the flush
    boundaries: the port's 1024-slot spans flush elsewhere than the
    reference's 256-slot ones, and a key last seen in an early batch may
    have left one buffer and not the other.)"""
    evs = _events(nsteps=6)
    dense = _engine("dense")
    for k, v in evs:
        dense.ingest(np.broadcast_to(k[None], (B, k.size)),
                     np.broadcast_to(v[None], (B, v.size)))
    dense.flush()
    eng = _engine("sparse")
    PrefetchingFeeder(ShardedSource(evs, num_shards=4), eng,
                      block_elems=256).run()
    st, dst = eng.state, dense.state
    _assert_table_close(st.sketch.table, dst.sketch.table)
    got, want = _union_sample(st, dst, 8), _union_sample(dst, st, 8)
    assert np.array_equal(np.sort(got.keys.numpy(), 1),
                          np.sort(want.keys.numpy(), 1))


def test_fanin_matches_reference_package():
    """The port's fan-in into its sparse plane against the JAX package's
    fan-in into its own: the same events in the same order (other spans),
    tables within the bound, the same sample keys."""
    evs = _events(nsteps=6)
    eng = _engine("sparse")
    PrefetchingFeeder(ShardedSource(evs, num_shards=2), eng,
                      block_elems=256).run()
    jeng = JE.SketchEngine(JE.EngineConfig(**_cfg()), plane="sparse",
                           flush_elems=1)
    JI.PrefetchingFeeder(JI.ShardedSource(evs, num_shards=2), jeng,
                         block_elems=256).run()
    _assert_table_close(eng.state.sketch.table, jeng.state.sketch.table)
    assert np.array_equal(eng.sample(8).keys.numpy(),
                          np.asarray(jeng.sample(8).keys))


def test_pershard_collapse_matches_reference():
    evs = _events(nsteps=6)
    ref = _sync_reference(evs, shards=4)
    eng = SketchEngine(EngineConfig(**_cfg()), plane="pipeline",
                       flush_elems=1, device="cpu",
                       plane_opts={"shards": 4})
    stats = PrefetchingFeeder(ShardedSource(evs, num_shards=4), eng,
                              block_elems=256, pershard=True).run()
    assert stats.events == sum(k.size for k, _ in evs)
    _assert_table_close(eng.state.sketch.table, ref.state.sketch.table)
    eng.plane.close()


@pytest.mark.parametrize("subplane", ["sparse", "async"])
def test_pershard_async_subplanes_bitwise(subplane):
    """Per-shard producers into async sub-planes equal sparse sub-planes
    bit for bit (each shard's block order is its producer's)."""
    evs = _events(nsteps=5)
    engs = {}
    for sub in ("sparse", subplane):
        e = SketchEngine(EngineConfig(**_cfg()), plane="pipeline",
                         flush_elems=1, device="cpu",
                         plane_opts={"shards": 2, "subplane": sub})
        PrefetchingFeeder(ShardedSource(evs, num_shards=2), e,
                          block_elems=256, pershard=True).run()
        engs[sub] = e
    assert _leaves_equal(engs["sparse"].state, engs[subplane].state)
    for e in engs.values():
        e.plane.close()


def test_interleaved_update_while_producers_active():
    evs = _events(nsteps=8)
    rng = np.random.default_rng(3)
    uk = rng.integers(0, 2000, (B, 16)).astype(np.int32)
    uv = rng.normal(size=(B, 16)).astype(np.float32)
    eng = _engine("sparse")
    feeder = PrefetchingFeeder(ShardedSource(evs, num_shards=4), eng,
                               block_elems=256, prefetch=1)
    feeder.start()
    assert feeder.pump(max_blocks=1) == 1
    eng.update(uk, uv)
    feeder.pump()
    feeder.finish()
    ref = _engine("sparse")
    for i, blk in enumerate(_round_robin(_blocks(PackedBatcher, evs, 4, 256,
                                                 B))):
        ref.ingest(*blk)
        if i == 0:
            ref.update(uk, uv)
    ref.flush()
    assert _leaves_equal(eng.state, ref.state)


def test_pershard_requires_pipeline_plane():
    with pytest.raises(ValueError, match="PipelinePlane"):
        PrefetchingFeeder(ShardedSource([], num_shards=2), _engine(),
                          pershard=True)
    pipe = SketchEngine(EngineConfig(**_cfg()), plane="pipeline",
                        device="cpu", plane_opts={"shards": 3})
    with pytest.raises(ValueError, match="shard-count mismatch"):
        PrefetchingFeeder(ShardedSource([], num_shards=2), pipe,
                          pershard=True)


# ---------------------------------------------------------------------------
# backpressure, errors, close
# ---------------------------------------------------------------------------

def test_zero_prefetch_is_rendezvous_and_lossless():
    evs = _events(nsteps=6, n=200)
    feeder = PrefetchingFeeder(ShardedSource(evs, num_shards=2), _engine(),
                               block_elems=256, prefetch=0)
    assert all(r.maxsize == 1 for r in feeder._rings)
    stats = feeder.run()
    assert stats.events == sum(k.size for k, _ in evs)
    ref = PrefetchingFeeder(ShardedSource(evs, num_shards=2), _engine(),
                            block_elems=256, prefetch=8)
    ref.run()
    assert _leaves_equal(feeder.sink.state, ref.sink.state)


def test_producers_block_on_full_ring_never_drop():
    evs = _events(nsteps=8, n=1500)
    eng = _engine()
    feeder = PrefetchingFeeder(ShardedSource(evs, num_shards=2), eng,
                               block_elems=128, prefetch=1)
    feeder.start()
    t0 = time.monotonic()
    while (any(r.qsize() < 1 for r in feeder._rings)
           and time.monotonic() - t0 < WAIT_S):
        time.sleep(0.01)
    assert all(r.qsize() >= 1 for r in feeder._rings)  # full, stalled
    assert all(t.is_alive() for t in feeder._threads)  # blocked, alive
    feeder.pump()
    stats = feeder.finish()
    assert stats.events == sum(k.size for k, _ in evs)
    assert stats.producer_wait_s > 0.0
    assert stats.pack_efficiency <= 1.0 and stats.events_per_s > 0


def test_producer_error_surfaces_at_drain_no_deadlock():
    good = _events(nsteps=3, n=1500)

    def poisoned():
        yield from good
        raise ValueError("upstream store fell over")

    eng = _engine()
    feeder = PrefetchingFeeder(ShardedSource(poisoned, num_shards=3), eng,
                               block_elems=128)
    with pytest.raises(RuntimeError, match="producer shard") as info:
        feeder.run()
    assert isinstance(info.value.__cause__, ValueError)
    for t in feeder._threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert bool(eng.flush().state.sketch.table.any())
    assert eng.sample(4).keys.shape == (B, 4)


def test_close_unblocks_stalled_producers():
    evs = _events(nsteps=8, n=1500)
    feeder = PrefetchingFeeder(ShardedSource(evs, num_shards=2), _engine(),
                               block_elems=128, prefetch=1)
    feeder.start()
    t0 = time.monotonic()
    feeder.close()
    assert time.monotonic() - t0 < WAIT_S
    assert all(not t.is_alive() for t in feeder._threads)


def test_empty_source_and_validation():
    stats = PrefetchingFeeder(ShardedSource([], num_shards=2), _engine(),
                              block_elems=128).run()
    assert stats.events == 0 and stats.blocks == 0
    assert stats.pack_efficiency == 1.0
    eng = _engine()
    with pytest.raises(ValueError, match="prefetch"):
        PrefetchingFeeder(ShardedSource([], num_shards=1), eng, prefetch=-1)
    feeder = PrefetchingFeeder(ShardedSource([], num_shards=1), eng)
    feeder.run()
    with pytest.raises(RuntimeError, match="already started"):
        feeder.start()
    assert isinstance(stats, I.FeederStats)


# ---------------------------------------------------------------------------
# FrequencySketcher against the reference
# ---------------------------------------------------------------------------

def _sketchers(**kw):
    return (D.FrequencySketcher(device="cpu", **kw),
            JD.FrequencySketcher(**kw))


def _assert_sketcher_close(got, want, k):
    _assert_table_close(got.state.sketch.table.numpy(),
                        want.state.sketch.table)
    assert np.array_equal(got.state.cand_keys.numpy(),
                          np.asarray(want.state.cand_keys))
    gs, ws = got.sample(), want.sample()
    assert np.array_equal(gs.keys.numpy(), np.asarray(ws.keys))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_frequency_sketcher_signed_matches_reference(use_kernel):
    got, want = _sketchers(k=16, rows=5, p=0.5, seed=23)
    stream = D.TurnstileZipfStream(5000, 1.3, 4, delete_fraction=0.25)
    for step in range(5):
        k, v = stream.sparse_batch_at(step, 0, 600)
        got.observe_signed(k, v, use_kernel=use_kernel)
        want.observe_signed(k, v, use_kernel=use_kernel)
    _assert_sketcher_close(got, want, 16)


def test_frequency_sketcher_observe_merge_weights():
    a, ja = _sketchers(k=8, rows=3, p=0.5, seed=5)
    b, jb = _sketchers(k=8, rows=3, p=0.5, seed=5)
    z = D.ZipfStream(3000, 1.4, 2)
    toks_a, toks_b = z.batch_at(0, 0, 4, 64), z.batch_at(0, 1, 4, 64)
    a.observe(toks_a)
    ja.observe(jnp.asarray(toks_a))
    b.observe(torch.from_numpy(toks_b))
    jb.observe(jnp.asarray(toks_b))
    a.merge_from(b)
    ja.merge_from(jb)
    _assert_sketcher_close(a, ja, 8)
    w = a.selection_weights(toks_a)
    jw = np.asarray(ja.selection_weights(jnp.asarray(toks_a)))
    assert w.shape == toks_a.shape
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4)


def test_frequency_sketcher_kernel_path_equals_plain():
    """On the CPU the kernel path's wrappers run their plain versions: the
    same state as the plain path, but for float summation order."""
    plain, kern = (D.FrequencySketcher(k=8, rows=3, seed=9, device="cpu")
                   for _ in range(2))
    stream = D.TurnstileZipfStream(2000, 1.2, 1)
    for step in range(4):
        k, v = stream.sparse_batch_at(step, 0, 300)
        plain.observe_signed(k, v)
        kern.observe_signed(k, v, use_kernel=True)
    _assert_table_close(kern.state.sketch.table, plain.state.sketch.table)
    assert torch.equal(kern.state.cand_keys, plain.state.cand_keys)
