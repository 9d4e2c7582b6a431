"""The port's async and pipeline planes, its plane registry and its
deterministic flush path, on the CPU.

* The port's ``async`` plane equals its ``sparse`` plane bit for bit (state
  and sample) for every sampler and both schemes, deletions and windowed
  retractions included: dispatch boundaries are decided on the producer
  side, and every CPU sum is in a fixed order.
* The port's ``async`` and ``pipeline`` planes against the JAX package's on
  the same numpy inputs: tables within the reference's scale-aware bound,
  rtol 1e-4 / atol 1e-5 * max(1, max|want|) (float sums in another order,
  and the transform's -log/pow by a few ulps); candidate and sample keys
  identical (the inputs are well separated).
* ``partition_by_key``'s live entries equal the reference's bit for bit;
  only the padding width differs.
* Errors re-queue their batches in order, the interval timer publishes a
  stalled producer's tail, ``close()`` fences a racing timer, and no
  worker thread outlives ``close()``.  Every wait is bounded.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import hashing as jhashing
from repro.engine import planes as JP
from repro_torch import convert
from repro_torch.core import worp
from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine
from repro_torch.engine import engine as TE
from repro_torch.engine import planes as P
from repro_torch.kernels import ops, ref, tiling

B = 3
SCHEMES = ["ppswor", "priority"]
SAMPLERS = ["onepass", "perfect", "tv", "twopass"]
WAIT_S = 10.0  # the longest any test waits for a worker or a timer


def _cfg(name, scheme="ppswor", **kw):
    base = dict(num_streams=B, rows=3, width=128, candidates=64,
                capacity=64, p=1.0, scheme=scheme, seed=11, sampler=name,
                domain=40, num_samplers=3)
    base.update(kw)
    return base


def _sparse(seed=0, n=60, domain=40):
    """Keys over a small domain with well-separated positive frequencies
    (the sample keys do not depend on batching or summation order)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, domain, (B, n)).astype(np.int32)
    vals = (rng.random((B, n)).astype(np.float32) + 0.5) \
        * (1 + (keys % 7 == 0) * 20)
    return keys, vals


def _engine(cfg, plane="sparse", **kw):
    return SketchEngine(EngineConfig(**cfg), plane=plane, device="cpu", **kw)


def _leaves(st):
    return convert.state_to_numpy(st)


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.dtype, x.shape, x.view(np.uint8)


def _same(x, y):
    (dx, sx, bx), (dy, sy, by) = _bits(x), _bits(y)
    return dx == dy and sx == sy and np.array_equal(bx, by)


def _assert_bitwise(a, b, msg=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    assert all(_same(x, y) for x, y in zip(la, lb)), msg


def _assert_samples_bitwise(s1, s2, msg=""):
    for f in ("keys", "freqs", "threshold", "transformed"):
        assert _same(getattr(s1, f).numpy(), getattr(s2, f).numpy()), (msg, f)


def _run(cfg, plane, keys, vals, flush_elems, step=8, **kw):
    eng = _engine(cfg, plane, flush_elems=flush_elems, **kw)
    for lo in range(0, keys.shape[1], step):
        eng.ingest(keys[:, lo:lo + step], vals[:, lo:lo + step])
    eng.flush()
    return eng


def _workers():
    return {t for t in threading.enumerate()
            if t.name == "repro-torch-async-plane" and t.is_alive()}


# --------------------------------------------------------------------------
# flush policy and registry
# --------------------------------------------------------------------------

def test_flush_policy_triggers():
    assert not FlushPolicy(max_elems=10).should_flush(9, 10**9, 10**9)
    assert FlushPolicy(max_elems=10).should_flush(10, 0, 0.0)
    pol = FlushPolicy(max_elems=None, max_bytes=64)
    assert not pol.should_flush(10**6, 63, 0.0) and pol.should_flush(0, 64,
                                                                      0.0)
    pol = FlushPolicy(max_elems=None, max_interval=5.0)
    assert not pol.should_flush(10**6, 10**9, 4.9)
    assert pol.should_flush(0, 0, 5.0)


@pytest.mark.parametrize("plane", ["sparse", "async", "dense"])
def test_interval_zero_dispatches_every_ingest(plane):
    """The synchronous planes test the interval at ingest time."""
    keys, vals = _sparse(seed=2)
    eng = _engine(_cfg("onepass"), plane,
                  flush=FlushPolicy(max_elems=None, max_interval=0.0))
    eng.ingest(keys[:, :10], vals[:, :10])
    assert eng.pending == 0
    assert eng.state.sketch.table.abs().sum() > 0
    eng.plane.close()


def test_registry_order_alias_and_plane_opts():
    assert P.available_planes() == ("dense", "sparse", "async", "pipeline")
    cfg = _cfg("onepass")
    eng = _engine(cfg)
    plane = P.make_plane("ingest", eng.spec, eng.state)
    assert isinstance(plane, P.SparsePlane) and plane.name == "sparse"
    assert not isinstance(plane, P.AsyncPlane)
    with pytest.raises(ValueError, match="unknown data plane"):
        _engine(cfg, "warp")
    pipe = _engine(cfg, "pipeline",
                   plane_opts={"shards": 4, "subplane": "async"})
    assert isinstance(pipe.plane, P.PipelinePlane)
    assert pipe.plane.shards == 4 and pipe.plane.subplane == "async"
    assert all(isinstance(s, P.AsyncPlane) for s in pipe.plane._subplanes)
    pipe.plane.close()
    with pytest.raises(TypeError):
        _engine(cfg, "sparse", plane_opts={"shards": 2})


@pytest.mark.parametrize("plane", ["dense", "sparse", "async", "pipeline"])
@pytest.mark.parametrize("name", ["onepass", "perfect"])
def test_padding_keys_contribute_nothing(name, plane):
    cfg = _cfg(name)
    keys, vals = _sparse(seed=20, n=24)
    a = _engine(cfg, plane)
    a.ingest(np.concatenate([keys, np.full((B, 8), -1, np.int32)], 1),
             np.concatenate([vals, np.ones((B, 8), np.float32)], 1))
    b = _engine(cfg, plane)
    b.ingest(keys, vals)
    _assert_samples_bitwise(a.sample(4), b.sample(4), f"{name}/{plane}")
    a.plane.close()
    b.plane.close()


# --------------------------------------------------------------------------
# async == sparse, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", SAMPLERS)
def test_async_bitwise_state_and_sample(name, scheme):
    cfg = _cfg(name, scheme)
    keys, vals = _sparse(seed=4, n=64)
    sync = _run(cfg, "sparse", keys, vals, 20)
    asyn = _run(cfg, "async", keys, vals, 20)
    _assert_bitwise(sync.state, asyn.state, name)
    _assert_samples_bitwise(sync.sample(4), asyn.sample(4), name)
    asyn.plane.close()


def test_async_deletions_bitwise():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=5, n=64)
    skeys = np.concatenate([keys, keys[:, :32]], 1)
    svals = np.concatenate([vals, -vals[:, :32]], 1)
    sync = _run(cfg, "sparse", skeys, svals, 24)
    asyn = _run(cfg, "async", skeys, svals, 24)
    _assert_bitwise(sync.state, asyn.state)
    asyn.plane.close()


@pytest.mark.parametrize("name", ["onepass", "twopass", "tv"])
def test_windowed_retraction_bitwise(name):
    """A sliding window's signed drain (each step retracted once it leaves
    the window) gives the same bits on both planes."""
    rng = np.random.default_rng(14)
    steps = [rng.integers(0, 40, (B, 8)).astype(np.int32) for _ in range(12)]
    engs = []
    for plane in ("sparse", "async"):
        eng = _engine(_cfg(name), plane, flush_elems=20)
        live = []
        for t in steps:
            eng.ingest(t, np.ones(t.shape, np.float32))
            live.append(t)
            if len(live) > 4:
                old = live.pop(0)
                eng.ingest(old, -np.ones(old.shape, np.float32))
        eng.flush()
        engs.append(eng)
    _assert_bitwise(engs[0].state, engs[1].state, name)
    _assert_samples_bitwise(engs[0].sample(4), engs[1].sample(4), name)
    engs[1].plane.close()


def test_async_state_read_settles_without_flushing():
    keys, vals = _sparse(seed=6, n=40)
    eng = _engine(_cfg("onepass"), "async", flush_elems=20)
    eng.ingest(keys[:, :20], vals[:, :20])      # handed to the worker
    eng.ingest(keys[:, 20:30], vals[:, 20:30])  # stays buffered
    st = eng.state
    assert eng.pending == 10 and st.sketch.table.abs().sum() > 0
    eng.plane.close()


@pytest.mark.parametrize("plane", ["sparse", "async"])
@pytest.mark.parametrize("name", ["twopass", "tv"])
def test_interleaved_update_equals_flushed_order(name, plane):
    """``update`` drains the ingest buffer (and the async worker) first."""
    cfg = _cfg(name)
    keys, vals = _sparse(seed=10, n=60)
    eng = _engine(cfg, plane, flush_elems=10_000)
    eng.ingest(keys[:, :20], vals[:, :20])
    eng.update(keys[:, 20:40], vals[:, 20:40])
    eng.ingest(keys[:, 40:], vals[:, 40:])
    agg = _engine(cfg, plane)
    agg.ingest(keys[:, :20], vals[:, :20])
    agg.flush()
    agg.update(keys[:, 20:40], vals[:, 20:40])
    agg.ingest(keys[:, 40:], vals[:, 40:])
    _assert_samples_bitwise(eng.sample(4), agg.sample(4), name)
    eng.plane.close()
    agg.plane.close()


def test_checkpoint_boundary_restores_into_async():
    cfg = _cfg("twopass")
    keys, vals = _sparse(seed=7)
    sync = _run(cfg, "sparse", keys, vals, 16)
    asyn = _run(cfg, "async", keys, vals, 16)
    fresh = _engine(cfg, "async")
    fresh.state = asyn.state
    _assert_bitwise(sync.state, fresh.state)
    more_k, more_v = _sparse(seed=8, n=16)
    sync.update(more_k, more_v)
    fresh.update(more_k, more_v)
    _assert_bitwise(sync.state, fresh.state)
    for eng in (asyn, fresh):
        eng.plane.close()


# --------------------------------------------------------------------------
# against the JAX package's planes
# --------------------------------------------------------------------------

def _tables_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _jax_run(cfg, plane, keys, vals, flush_elems, step=8, **kw):
    eng = JE.SketchEngine(JE.EngineConfig(**cfg), plane=plane,
                          flush_elems=flush_elems, **kw)
    for lo in range(0, keys.shape[1], step):
        eng.ingest(keys[:, lo:lo + step], vals[:, lo:lo + step])
    eng.flush()
    return eng


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", ["onepass", "twopass"])
def test_async_matches_jax_async(name, scheme):
    cfg = _cfg(name, scheme)
    keys, vals = _sparse(seed=40, n=64)
    got = _run(cfg, "async", keys, vals, 20)
    want = _jax_run(cfg, "async", keys, vals, 20)
    gst, wst = got.state, want.state
    gone = gst if name == "onepass" else gst.pass1
    wone = wst if name == "onepass" else wst.pass1
    _tables_close(gone.sketch.table.numpy(), wone.sketch.table)
    assert np.array_equal(gone.cand_keys.numpy(), np.asarray(wone.cand_keys))
    if name == "twopass":
        assert np.array_equal(gst.pass2.keys.numpy(),
                              np.asarray(wst.pass2.keys))
    assert np.array_equal(got.sample(4).keys.numpy(),
                          np.asarray(want.sample(4).keys))
    got.plane.close()
    want.plane.close()


def test_partition_by_key_live_entries_match_reference():
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 5000, (B, 300)).astype(np.int32)
    keys[:, ::11] = -1
    vals = rng.normal(size=(B, 300)).astype(np.float32)
    for shards in (1, 2, 3, 5):
        got = P.partition_by_key(keys, vals, shards)
        want = JP.partition_by_key(keys, vals, shards)
        assert len(got) == len(want) == shards
        seen = 0
        for (gk, gv), (wk, wv) in zip(got, want):
            wk, wv = np.asarray(wk), np.asarray(wv)
            assert gk.shape[1] % P.SHARD_PAD == 0
            assert gk.dtype == np.int32 and gv.dtype == np.float32
            # the same live entries in the same columns; padding past them
            m = min(gk.shape[1], wk.shape[1])
            assert np.array_equal(gk[:, :m], wk[:, :m])
            assert np.array_equal(gv[:, :m].view(np.int32),
                                  wv[:, :m].view(np.int32))
            assert not (gk[:, m:] != -1).any() and not (wk[:, m:] != -1).any()
            assert not gv[:, m:].any()
            seen += int((gk != -1).sum())
        assert seen == int((keys != -1).sum())
    shard = jhashing.shard_of_keys(keys, 3)
    assert np.array_equal(shard, P.hashing.shard_of_keys(keys, 3))


@pytest.mark.parametrize("name", ["onepass", "perfect"])
def test_pipeline_collapse_matches_jax_and_sparse(name):
    cfg = _cfg(name)
    keys, vals = _sparse(seed=33, n=64)
    pipe = _run(cfg, "pipeline", keys, vals, 16, step=16,
                plane_opts={"shards": 3})
    jpipe = _jax_run(cfg, "pipeline", keys, vals, 16, step=16,
                     plane_opts={"shards": 3})
    sparse = _run(cfg, "sparse", keys, vals, 16, step=16)
    for other in (jax.tree_util.tree_leaves(jpipe.state),
                  _leaves(sparse.state)):
        for g, w in zip(_leaves(pipe.state), other):
            w = np.asarray(w)
            if np.issubdtype(w.dtype, np.floating):
                _tables_close(g, w)
    for other in (jpipe, sparse):
        assert np.array_equal(pipe.sample(4).keys.numpy(),
                              np.asarray(other.sample(4).keys))
    pipe.plane.close()
    jpipe.plane.close()


def test_pipeline_async_subplanes_equal_sparse_subplanes():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=35, n=64)
    engs = [_run(cfg, "pipeline", keys, vals, 16,
                 plane_opts={"shards": 3, "subplane": sub})
            for sub in ("sparse", "async")]
    _assert_bitwise(engs[0].state, engs[1].state)
    _assert_samples_bitwise(engs[0].sample(4), engs[1].sample(4))
    for eng in engs:
        eng.plane.close()


def test_pipeline_ingest_shard_equals_self_partition():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=34, n=48)
    a = _engine(cfg, "pipeline", plane_opts={"shards": 2})
    b = _engine(cfg, "pipeline", plane_opts={"shards": 2})
    a.ingest(keys, vals)
    a.flush()
    for s, (k, v) in enumerate(P.partition_by_key(keys, vals, 2)):
        if k.shape[1]:
            b.plane.ingest_shard(s, k, v)
    b.flush()
    _assert_bitwise(a.state, b.state)


def test_pipeline_set_state_and_validation():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=36, n=40)
    src = _engine(cfg)
    src.ingest(keys, vals)
    src.flush()
    pipe = _engine(cfg, "pipeline", plane_opts={"shards": 3})
    pipe.state = src.state  # shard 0 takes it, the others stay empty
    _assert_samples_bitwise(src.sample(4), pipe.sample(4))
    with pytest.raises(ValueError, match="nest"):
        P.make_plane("pipeline", src.spec, src.state, subplane="pipeline")
    with pytest.raises(ValueError, match="shards"):
        P.make_plane("pipeline", src.spec, src.state, shards=0)
    assert TE._MERGES["onepass"] is pipe.plane._merge


# --------------------------------------------------------------------------
# errors, the timer, close() and threads
# --------------------------------------------------------------------------

def _planes(cfg, policy):
    eng = _engine(cfg)
    return (P.make_plane("async", eng.spec, eng.state, policy=policy),
            P.make_plane("sparse", eng.spec, eng.state, policy=policy))


def test_failed_dispatch_requeues_raises_then_retries():
    keys, vals = _sparse(seed=9, n=20)
    plane, ref_plane = _planes(_cfg("onepass"), FlushPolicy(max_elems=10))
    real, calls = plane._dispatch, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected dispatch failure")
        return real(*a, **kw)

    plane._dispatch = flaky
    plane.ingest(keys[:, :10], vals[:, :10])    # submitted; the worker fails
    with pytest.raises(RuntimeError, match="re-queued"):
        plane.drain()
    assert plane.pending == 10
    plane.ingest(keys[:, 10:], vals[:, 10:])    # the retry takes both
    plane.drain()
    ref_plane.ingest(keys, vals)
    ref_plane.drain()
    _assert_bitwise(plane.state, ref_plane.state)
    plane.close()


def test_batch_queued_behind_failure_keeps_order():
    """A batch queued behind a failed dispatch parks; the error raised at
    the next flush settles the queue first, so [failed, parked, new] are
    re-queued in their order (the twopass state depends on it)."""
    cfg = _cfg("twopass", capacity=8, candidates=8)
    rng = np.random.default_rng(19)
    k = rng.integers(0, 40, (B, 30)).astype(np.int32)
    v = (rng.random((B, 30)).astype(np.float32) + 0.5) \
        * (1 + (np.arange(30) < 10) * 30)
    plane, ref_plane = _planes(cfg, FlushPolicy(max_elems=10))
    real, calls = plane._dispatch, {"n": 0}
    release = threading.Event()

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            release.wait(WAIT_S)  # hold batch 2 in the queue behind it
            raise RuntimeError("injected dispatch failure")
        return real(*a, **kw)

    plane._dispatch = flaky
    plane.ingest(k[:, :10], v[:, :10])      # batch 1: will fail
    plane.ingest(k[:, 10:20], v[:, 10:20])  # batch 2: queued behind it
    release.set()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        with plane._lock:
            if plane._error is not None:
                break
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="re-queued"):
        plane.ingest(k[:, 20:], v[:, 20:])  # batch 3's flush sees the error
    assert plane.pending == 30
    plane.drain()
    ref_plane = P.make_plane("sparse", plane.spec, _engine(cfg).state,
                             policy=FlushPolicy(max_elems=30))
    ref_plane.ingest(k, v)                  # one in-order dispatch
    ref_plane.drain()
    _assert_bitwise(plane.state, ref_plane.state)
    plane.close()


def _wait_for(cond):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def test_timer_publishes_a_stalled_producers_tail():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=30, n=12)
    eng = _engine(cfg, "async",
                  flush=FlushPolicy(max_elems=None, max_interval=0.05))
    t0 = time.monotonic()
    eng.ingest(keys, vals)  # under every ingest-time trigger; then stall
    # .state settles in-flight work but does not flush the host buffer:
    # only the timer can have dispatched this batch
    assert _wait_for(lambda: bool(eng.state.sketch.table.abs().sum() > 0))
    assert eng.pending == 0 and time.monotonic() - t0 >= 0.05
    ref_eng = _engine(cfg)
    ref_eng.ingest(keys, vals)
    ref_eng.flush()
    _assert_bitwise(eng.state, ref_eng.state)
    eng.plane.close()


def test_timer_does_not_fire_early_and_drain_cancels_it():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=31, n=12)
    eng = _engine(cfg, "async",
                  flush=FlushPolicy(max_elems=None, max_interval=30.0))
    eng.ingest(keys, vals)
    time.sleep(0.15)
    assert eng.pending == keys.shape[1]  # still buffered
    eng.plane.close()
    fast = _engine(cfg, "async",
                   flush=FlushPolicy(max_elems=None, max_interval=0.05))
    fast.ingest(keys, vals)
    fast.flush()                          # beats the timer
    time.sleep(0.2)                       # the timer's window passes
    ref_eng = _engine(cfg)
    ref_eng.ingest(keys, vals)
    ref_eng.flush()
    _assert_bitwise(fast.state, ref_eng.state)  # applied exactly once
    fast.plane.close()


def test_timer_racing_close_neither_restarts_nor_dispatches():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=33, n=12)
    before = _workers()
    eng = _engine(cfg, "async",
                  flush=FlushPolicy(max_elems=None, max_interval=60.0))
    plane = eng.plane
    eng.ingest(keys, vals)
    eng.flush()                 # starts the worker; the buffer is empty
    eng.ingest(keys, vals)      # buffered again, timer armed
    plane.close()
    assert plane._worker is None
    plane._timer_fire()         # a callback that was past cancel()
    assert plane._worker is None and eng.pending == keys.shape[1]
    assert not (_workers() - before)
    eng.ingest(keys, vals)      # an explicit ingest reopens the plane
    eng.flush()
    ref_eng = _engine(cfg)
    ref_eng.ingest(keys, vals)
    ref_eng.flush()
    ref_eng.ingest(keys, vals)
    ref_eng.ingest(keys, vals)
    ref_eng.flush()
    _assert_bitwise(eng.state, ref_eng.state)
    plane.close()


def test_close_ingest_loop_loses_nothing():
    cfg = _cfg("onepass")
    keys, vals = _sparse(seed=34, n=8)
    before = _workers()
    eng = _engine(cfg, "async",
                  flush=FlushPolicy(max_elems=None, max_interval=0.001))
    for _ in range(6):
        eng.ingest(keys, vals)
        time.sleep(0.002)       # some timers win, some lose
        eng.plane.close()
        eng.flush()             # either way, one dispatch per round
    ref_eng = _engine(cfg)
    for _ in range(6):
        ref_eng.ingest(keys, vals)
        ref_eng.flush()
    _assert_bitwise(eng.state, ref_eng.state)
    eng.plane.close()
    assert not (_workers() - before)


def test_worker_starts_on_first_flush_and_stops_on_close():
    eng = _engine(_cfg("onepass"), "async")
    assert eng.plane._worker is None
    keys, vals = _sparse(seed=18, n=8)
    eng.ingest(keys, vals)
    eng.flush()
    worker = eng.plane._worker
    assert worker is not None and worker.is_alive() and worker.daemon
    assert eng.plane in P._LIVE_ASYNC
    eng.plane.close()
    worker.join(WAIT_S)
    assert not worker.is_alive()
    eng.plane.close()  # a second close is a no-op


def test_synchronous_planes_close_is_a_no_op():
    eng = _engine(_cfg("onepass"))
    eng.plane.close()
    keys, vals = _sparse(seed=1, n=8)
    eng.ingest(keys, vals)
    assert eng.sample(4).keys.shape == (B, 4)


# --------------------------------------------------------------------------
# the deterministic mode on the CPU
# --------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.parametrize("name", SAMPLERS)
def test_deterministic_mode_async_equals_sparse(name, deterministic):
    """The mode changes nothing on the CPU: both planes, under it, give
    the bits they give without it."""
    cfg = _cfg(name)
    keys, vals = _sparse(seed=42, n=48)
    engs = [_run(cfg, plane, keys, vals, 16) for plane in ("sparse",
                                                           "async")]
    _assert_bitwise(engs[0].state, engs[1].state)
    torch.use_deterministic_algorithms(False)
    plain = _run(cfg, "sparse", keys, vals, 16)
    _assert_bitwise(engs[0].state, plain.state)
    engs[1].plane.close()


def test_segment_sum_forms_agree(deterministic):
    """``worp.segment_sum`` under the mode takes the segment-sum wrapper,
    whose CPU form is the plain ``scatter_add_``: the same bits as the
    default path, runs summed in index order."""
    rng = np.random.default_rng(43)
    keys = np.sort(rng.integers(0, 30, (4, 200)), 1)
    first = np.ones(keys.shape, bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    seg = torch.from_numpy(np.cumsum(first, 1) - 1)
    vals = torch.from_numpy(rng.normal(size=(4, 200)).astype(np.float32))
    got = worp.segment_sum(vals, seg)
    want = ref.segment_sum_ref(vals, seg)
    assert torch.equal(got, want) and torch.equal(ops.segment_sum(vals, seg),
                                                  want)
    r0 = vals[0][seg[0] == 0]
    acc = torch.zeros(())
    for x in r0:
        acc = acc + x
    assert got[0, 0] == acc


def test_det_plan_by_mode_and_shape():
    """The deterministic scatter: one block per stream, a warp a row, the
    table and a 1024-slot stage in shared memory; a table past a block's
    shared memory raises, naming the shape (no fallback to atomics)."""
    plan = tiling.table_plan(4096, 5120, None, 7, 2048, 132,
                             deterministic=True)
    assert plan == tiling.TablePlan("det", 4096, 224, tiling.DET_TILE, True,
                                    7 * 2048 * 4 + tiling.DET_TILE * 8)
    assert tiling.table_plan(3, 10, None, 40, 64, 132,
                             deterministic=True).threads \
        == 32 * tiling.DET_MAX_WARPS
    assert tiling.table_plan(3, 10, np.array([10] * 3), 7, 2048, 132,
                             variant="det").variant == "det"
    assert tiling.table_plan(3, 10, np.array([10] * 3), 7, 2048,
                             132).variant == "smem"
    assert tiling.det_fits(7, 8000) and not tiling.det_fits(7, 8192)
    with pytest.raises(ValueError, match="deterministic mode.*7 x 16384"):
        tiling.table_plan(2, 300, None, 7, 16384, 132, deterministic=True)
