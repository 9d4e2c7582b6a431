"""The port's multi-process serving fleet (``FleetCoordinator``, replica
processes, ``FaultPlan``, ``launch.fleet_serve``) on the CPU, against the
port's in-process ``fleet`` plane and the JAX package's.

Mirrors ``tests/test_fleet.py``'s process layers:
  * tier-1: a replica killed mid-stream (applied, not acked, not
    committed) is respawned from its last published checkpoint and
    replayed, and the aggregated sample equals the port's single-process
    ``fleet`` plane bit for bit; corrupt and wrong-seed publishes raise at
    the merge boundary (IOError, ValueError) and the fleet heals once the
    fault clears.  The kill run's sample keys equal those of the JAX
    package's in-process ``reference_sample``, its frequencies within the
    tables' tolerance (rtol/atol 2e-5).  ``fleet_serve.main --verify
    --device cpu`` prints ``parity=bitwise``.  The deterministic mode
    crosses the spawn, and a replica asked to run on a missing card fails
    the start instead of falling back to the CPU.
  * chaos (``-m chaos``, keyed by ``FLEET_CHAOS_SEED``): hang detection by
    probe, a slow replica under backpressure, three replicas under windowed
    turnstile retractions, a double kill -- each closing with the same
    bitwise assertion.

Every replica runs on the CPU (``FleetConfig(device="cpu")``) with one
torch thread (``child_env``); every coordinator stops its replicas on
exit (join with a deadline, then terminate and kill), and every wait is
bounded.
"""
import contextlib
import io
import os
import queue
import threading

import jax
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.distributed import fleet as JF
from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.distributed import fleet as F
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.kernels import launch_counts
from repro_torch.launch import fleet_serve
from repro_torch.launch.fleet_serve import traffic
from repro_torch.train import checkpoint

jax.config.update("jax_platform_name", "cpu")

FLEET_CHAOS_SEED = int(os.environ.get("FLEET_CHAOS_SEED", "0"))
ONE_THREAD = (("OMP_NUM_THREADS", "1"), ("MKL_NUM_THREADS", "1"))
TABLE_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@contextlib.contextmanager
def _deterministic(on: bool = True):
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _cfg(seed=7, **kw):
    base = dict(num_streams=3, rows=3, width=128, candidates=16,
                capacity=16, p=1.0, seed=seed, sampler="onepass",
                domain=40, num_samplers=8)
    base.update(kw)
    return base


def _batches(nb, seed, B=3, n=8, domain=40):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, domain, (B, n)).astype(np.int32),
             rng.integers(1, 4, (B, n)).astype(np.float32))
            for _ in range(nb)]


def _fcfg(cfg, **kw):
    # silence budgets wide enough that a loaded test host never reads a
    # healthy replica as dead (a death is seen by ``is_alive`` at once);
    # the hang scenario narrows them
    base = dict(engine=EngineConfig(**cfg), replicas=2, publish_every=2,
                ack_timeout=10.0, ping_timeout=5.0, device="cpu",
                child_env=ONE_THREAD)
    base.update(kw)
    return F.FleetConfig(**base)


def _bits(x):
    a = np.ascontiguousarray(x.detach().cpu().numpy())
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


def _assert_samples_equal(sample, ref):
    assert _bits(sample.keys) == _bits(ref.keys)
    assert _bits(sample.freqs) == _bits(ref.freqs)


def _reference(cfg, batches, replicas=2, k=4):
    return F.reference_sample(EngineConfig(**cfg), batches, replicas, k,
                              device="cpu")


# ---------------------------------------------------------------------------
# in-process pieces
# ---------------------------------------------------------------------------

def test_nesting_bounds_and_defaults():
    cfg = _cfg()
    with pytest.raises(ValueError, match="nest"):
        F.FleetCoordinator(_fcfg(cfg, plane="fleet"))
    with pytest.raises(ValueError, match="replicas"):
        F.FleetCoordinator(_fcfg(cfg, replicas=0))
    fc = F.FleetConfig(engine=EngineConfig(**cfg))
    # the port's replicas follow its device rule, not the reference's
    # host pinning
    assert fc.child_env == () and fc.device is None
    assert F.FleetConfig._fields[:-1] == JF.FleetConfig._fields
    assert F.FaultPlan._fields == JF.FaultPlan._fields
    co = F.FleetCoordinator(_fcfg(cfg))
    with pytest.raises(RuntimeError, match="not started"):
        co.route(*_batches(1, 0)[0])
    co.stop()
    assert not os.path.exists(co.root)


def test_coordinator_on_the_card_raises_without_one():
    """``device=None`` means the card: with none, the coordinator raises
    before it spawns anything (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.FleetCoordinator(_fcfg(_cfg(), device=None))


def test_corrupt_checkpoint_fails_crc(tmp_path):
    eng = SketchEngine(EngineConfig(**_cfg()), flush_elems=1, device="cpu")
    eng.ingest(*_batches(1, seed=9)[0])
    root = str(tmp_path / "shard")
    path = checkpoint.save(root, 3, eng.state)
    F._flip_committed_byte(path)
    with pytest.raises(IOError, match="CRC"):
        checkpoint.restore(root, 3, eng.state, device="cpu")


def test_forced_env_preexisting_values_win(monkeypatch):
    monkeypatch.setenv("REPRO_FLEET_A", "kept")
    monkeypatch.delenv("REPRO_FLEET_B", raising=False)
    with F._forced_env((("REPRO_FLEET_A", "x"), ("REPRO_FLEET_B", "y"))):
        assert os.environ["REPRO_FLEET_A"] == "kept"
        assert os.environ["REPRO_FLEET_B"] == "y"
    assert os.environ["REPRO_FLEET_A"] == "kept"
    assert "REPRO_FLEET_B" not in os.environ


def test_stats_percentiles_and_launch_tally():
    st = F.FleetStats()
    assert st.latency_percentile(50) == 0.0
    st.route_s = [0.001, 0.002, 0.003, 0.010]
    assert st.latency_percentile(50) == pytest.approx(0.0025)
    co = F.FleetCoordinator.__new__(F.FleetCoordinator)
    co.stats = st
    r = F._Replica(0, "unused")
    co._tally(r, {"scatter": 3, "estimate": 2})
    co._tally(r, {"scatter": 5, "estimate": 2})   # cumulative reports
    r.counts = {}                                 # a respawned process
    co._tally(r, {"scatter": 1, "estimate": 4})
    assert st.replica_launches == {"scatter": 6, "estimate": 6}
    assert set(launch_counts()) == {"scatter", "smem", "global", "det",
                                    "segment_sum", "estimate", "row_read",
                                    "other"}


def test_replica_protocol_in_process(tmp_path):
    """``_replica_main``'s messages, driven in a thread with plain queues:
    ready (with its pid, device and mode), pong, fault_set, ack, published
    (step, wire bytes, launch counts), an unknown command's error, and the
    stopped report."""
    cfg = EngineConfig(**_cfg())
    cmd_q, out_q = queue.Queue(), queue.Queue()
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    th = threading.Thread(target=F._replica_main, args=(
        0, cfg, "sparse", str(tmp_path / "r0"), cmd_q, out_q, F.FaultPlan(),
        "none", "cpu", mode), daemon=True)
    th.start()

    def get():
        return out_q.get(timeout=60.0)

    ready = get()
    assert ready[:2] == ("ready", 0)
    assert ready[2]["device"] == "cpu" and ready[2]["pid"] == os.getpid()
    assert ready[2]["init_s"] >= 0.0
    cmd_q.put(("ping", "t1"))
    assert get() == ("pong", "t1")
    cmd_q.put(("fault", F.FaultPlan(delay_s=0.0)))
    assert get() == ("fault_set",)
    k, v = _batches(1, 4)[0]
    cmd_q.put(("ingest", 1, k, v))
    assert get() == ("ack", 1)
    cmd_q.put(("publish",))
    msg = get()
    assert msg[:2] == ("published", 1) and msg[2] > 0
    assert msg[3] == launch_counts()
    assert checkpoint.latest_step(str(tmp_path / "r0")) == 1
    cmd_q.put(("bogus",))
    assert get()[0] == "error"
    cmd_q.put(("stop",))
    assert get()[0] == "stopped"
    th.join(timeout=30.0)
    assert not th.is_alive()
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == mode


# ---------------------------------------------------------------------------
# the process fleet (tier-1: one kill + one rejection flow)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kill_run():
    """Replica 1 dies abruptly AFTER applying its 3rd block but before
    acking or committing it (the worst-case window)."""
    cfg = _cfg()
    batches = _batches(10, seed=1)
    with F.FleetCoordinator(
            _fcfg(cfg), faults={1: F.FaultPlan(kill_after=3)}) as co:
        for k, v in batches:
            co.route(k, v)
        sample = co.sample(4)
        info = co.replica_info
        stats = co.stats
    return cfg, batches, sample, stats, info


def test_kill_midstream_restart_restores_bitwise_parity(kill_run):
    cfg, batches, sample, stats, info = kill_run
    assert stats.restarts == 1
    assert len(stats.start_s) == 3 and len(stats.recover_s) == 1
    assert all(i["device"] == "cpu" and not i["deterministic"]
               for i in info)
    assert stats.publishes > 0 and stats.published_bytes > 0
    _assert_samples_equal(sample, _reference(cfg, batches))


def test_kill_run_keys_equal_the_jax_reference(kill_run):
    """Cross-package: the coordinator's sample keys are those of the JAX
    package's in-process fleet plane; frequencies within the tables'
    tolerance."""
    cfg, batches, sample, _, _ = kill_run
    ref = JF.reference_sample(JE.EngineConfig(**cfg), batches, 2, 4)
    assert np.array_equal(sample.keys.numpy(), np.asarray(ref.keys))
    np.testing.assert_allclose(sample.freqs.numpy(), np.asarray(ref.freqs),
                               **TABLE_TOL)


def test_bad_shards_rejected_then_fleet_recovers():
    """Corrupted publish -> CRC IOError; wrong-seed publish -> merge
    ValueError; once the fault clears the next publish overwrites the
    poisoned artifact and the aggregate is bitwise correct.  Run in the
    deterministic mode, which every replica inherits across the spawn."""
    cfg = _cfg()
    batches = _batches(3, seed=1)
    with _deterministic():
        with F.FleetCoordinator(_fcfg(cfg)) as co:
            assert all(i["deterministic"] for i in co.replica_info)
            for k, v in batches:
                co.route(k, v)
            co.inject_fault(0, F.FaultPlan(corrupt_publish=True))
            with pytest.raises(IOError, match="CRC"):
                co.merged_state()
            co.inject_fault(0, F.FaultPlan(publish_wrong_seed=True))
            with pytest.raises(ValueError, match="seeds"):
                co.merged_state()
            co.inject_fault(0, F.FaultPlan())  # clear: self-heals
            sample = co.sample(4)
        _assert_samples_equal(sample, _reference(cfg, batches))


def test_replica_on_a_missing_card_fails_the_start():
    """A replica sent to the card resolves its device itself: with no card
    it raises, and the coordinator's start fails (no CPU replica)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    co = F.FleetCoordinator(_fcfg(_cfg(), replicas=1, start_timeout=60.0))
    co.cfg = co.cfg._replace(device="cuda")
    with pytest.raises(RuntimeError, match="failed to start"):
        with co:
            pass
    assert all(r.proc is None for r in co._replicas)


def test_fleet_serve_verify_prints_bitwise_parity(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = io.StringIO()
    with _deterministic(torch.are_deterministic_algorithms_enabled()), \
            contextlib.redirect_stdout(out):
        fleet_serve.main(["--replicas", "2", "--steps", "12",
                          "--kill-replica", "1", "--kill-after", "3",
                          "--verify", "--device", "cpu"])
    text = out.getvalue()
    assert "parity=bitwise" in text
    summary = [ln for ln in text.splitlines()
               if ln.startswith("fleet_serve_summary,")]
    assert len(summary) == 1 and ",restarts=1," in summary[0]


def test_traffic_matches_the_reference_traffic():
    from repro.data.pipeline import TurnstileZipfStream as JStream
    from repro.launch.fleet_serve import traffic as jtraffic

    got = traffic(TurnstileZipfStream(64, 1.2, 3), 3, 4, 6)
    want = jtraffic(JStream(64, 1.2, 3), 3, 4, 6)
    for (k, v), (jk, jv) in zip(got, want):
        assert np.array_equal(k, jk) and np.array_equal(v, jv)
        assert k.dtype == jk.dtype and v.dtype == jv.dtype


# ---------------------------------------------------------------------------
# chaos grid (FLEET_CHAOS_SEED)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
class TestChaosFleet:
    """Scripted kill/hang/delay chaos; every scenario's exit criterion is
    bitwise parity against the port's ``reference_sample``."""

    def _seeded_cfg(self, **kw):
        return _cfg(seed=7 ^ FLEET_CHAOS_SEED, **kw)

    def test_hang_detected_by_probe_and_recovered(self):
        cfg = self._seeded_cfg()
        batches = _batches(8, seed=FLEET_CHAOS_SEED)
        fcfg = _fcfg(cfg, ack_timeout=2.0, ping_timeout=1.0)
        with F.FleetCoordinator(
                fcfg, faults={0: F.FaultPlan(hang_after=2)}) as co:
            for k, v in batches:
                co.route(k, v)
            sample = co.sample(4)
            stats = co.stats
        assert stats.restarts >= 1
        assert stats.probes >= 1
        _assert_samples_equal(sample, _reference(cfg, batches))

    def test_slow_replica_backpressure_not_death(self):
        cfg = self._seeded_cfg()
        batches = _batches(8, seed=FLEET_CHAOS_SEED + 1)
        fcfg = _fcfg(cfg, queue_depth=1, publish_every=3,
                     ack_timeout=20.0, ping_timeout=5.0)
        with F.FleetCoordinator(
                fcfg, faults={0: F.FaultPlan(delay_s=0.05)}) as co:
            for k, v in batches:
                co.route(k, v)
            sample = co.sample(4)
            stats = co.stats
        assert stats.restarts == 0, "slow replica misdiagnosed as dead"
        _assert_samples_equal(sample, _reference(cfg, batches))

    def test_three_replicas_windowed_turnstile_kill(self):
        replicas = 3
        cfg = self._seeded_cfg(domain=64)
        stream = TurnstileZipfStream(vocab_size=64, alpha=1.2,
                                     seed=FLEET_CHAOS_SEED)
        batches = traffic(stream, 3, steps=10, batch=6)
        victim = FLEET_CHAOS_SEED % replicas
        fcfg = _fcfg(cfg, replicas=replicas)
        with F.FleetCoordinator(
                fcfg, faults={victim: F.FaultPlan(kill_after=4)}) as co:
            for k, v in batches:
                co.route(k, v)
            sample = co.sample(4)
            stats = co.stats
        assert stats.restarts == 1
        _assert_samples_equal(sample, _reference(cfg, batches, replicas))

    def test_double_kill_both_replicas_recover(self):
        cfg = self._seeded_cfg()
        batches = _batches(10, seed=FLEET_CHAOS_SEED + 2)
        faults = {0: F.FaultPlan(kill_after=2),
                  1: F.FaultPlan(kill_after=5)}
        with F.FleetCoordinator(_fcfg(cfg), faults=faults) as co:
            for k, v in batches:
                co.route(k, v)
            sample = co.sample(4)
            stats = co.stats
        assert stats.restarts == 2
        _assert_samples_equal(sample, _reference(cfg, batches))
