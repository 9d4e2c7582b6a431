"""Fault-injected multi-process serving fleet for composable sketches
(PyTorch port of ``repro.distributed.fleet``).

The paper's mergeability (merge(a, b) is the state of the union of the
shards' streams) is what lets WOR ell_p sampling run as a FLEET of
independent replicas.  This module makes that operational, with the
fault-injection machinery as part of the design:

``FleetPlane`` (registered data plane ``"fleet"``)
    the single-process model of the fleet's data path: the router's sticky
    per-key-hash partition (``planes.partition_by_key``) across R replica
    sub-planes, collapsed at every read through the CHECKPOINT merge
    protocol -- each replica state round-trips through ``train.checkpoint``
    (atomic commit + per-leaf CRC32) and the results reduce via
    ``sharding.merge_states`` under the seed-agreement guards.  It is the
    conformance grid's ``fleet`` path and the bitwise REFERENCE the
    multi-process fleet is held equal to.

``FleetCoordinator`` + ``_replica_main``
    R spawn-context OS processes, each owning a ``SketchEngine`` shard that
    dispatches every routed block immediately (``flush_elems=1``:
    reproducible dispatch boundaries).  State crosses the process boundary
    ONLY as committed checkpoint files; blocks, journal entries and
    messages cross as numpy arrays, never as CUDA tensors (CUDA IPC has
    lifetime rules that a killed replica breaks).  The coordinator restores
    and collapses the shards through the same ``merge_states`` reduction,
    so a corrupted shard fails its CRC (IOError) and a wrong-seed shard
    fails the merge guard (ValueError) instead of poisoning the union.

    The router is health-aware: bounded command queues give backpressure, a
    full queue or ack timeout triggers exponential-backoff retries and a
    ping probe, and a replica declared dead is killed, respawned and
    REPLAYED -- the coordinator journals every routed block until its
    replica confirms a publish, and a restarted replica restores its last
    committed checkpoint and receives exactly the journal suffix past it,
    so every block applies exactly once and the aggregated samples equal
    the single-process ``FleetPlane`` bit for bit where the replicas'
    sums are deterministic: on the card under
    ``torch.use_deterministic_algorithms(True)``, which each replica
    inherits from the coordinator's process; on the CPU with one torch
    thread per replica (``child_env``), as the tests run them.

    Replicas and the coordinator's reference engine run on the card unless
    ``FleetConfig.device`` asks for the CPU; a replica that finds no card
    raises, and the coordinator's start fails.

``FaultPlan``
    scripted fault injection, interpreted inside the replica process: kill
    (``os._exit``, no ack, no commit) or hang (stop servicing) after N
    ingests, per-ingest latency, and publish-time corruption (flip a byte
    in a committed leaf) or seed-swapping (publish a state hashed under a
    different seed).  Faults are one-shot: a recovered replica restarts
    with a clean plan.
"""
from __future__ import annotations

import collections
import contextlib
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.engine import planes
from repro_torch.kernels import launch_counts
from repro_torch.train import checkpoint

_KILL_EXIT = 17      # replica suicide exit code (distinguishes fault kills)
_HANG_S = 3600.0     # a "hung" replica sleeps this long (probe kills it)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class FaultPlan(NamedTuple):
    """Scripted faults, interpreted inside the replica process.  Ingest
    counts are measured from the moment the plan is installed (spawn or
    ``inject_fault``), so tests can script faults at exact stream points."""

    kill_after: Optional[int] = None   # os._exit after applying N ingests
                                       # (applied but NOT acked/committed)
    hang_after: Optional[int] = None   # stop servicing after N ingests
                                       # (alive but unresponsive)
    delay_s: float = 0.0               # injected latency per ingest
    corrupt_publish: bool = False      # flip a byte in the committed shard
    publish_wrong_seed: bool = False   # publish a state hashed under a
                                       # different seed (merge must reject)


def _flip_committed_byte(ckpt_path: str) -> None:
    """Corrupt a committed checkpoint in place: flip the last byte of the
    first leaf file (raw data region), leaving the manifest CRC stale --
    the restore side must refuse the shard."""
    leaf = sorted(f for f in os.listdir(ckpt_path) if f.endswith(".npy"))[0]
    with open(os.path.join(ckpt_path, leaf), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)[0]
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte ^ 0xFF]))


# ---------------------------------------------------------------------------
# fleet configuration
# ---------------------------------------------------------------------------

class FleetConfig(NamedTuple):
    """The fleet's operating point.  ``engine`` is shared verbatim by every
    replica (identical seeds => mergeable shards; the merge guards enforce
    it).  Timeouts are generous by default -- chaos tests shrink them."""

    engine: "EngineConfig"  # noqa: F821 (repro_torch.engine.EngineConfig)
    replicas: int = 2
    plane: str = "sparse"        # each replica's engine data plane
    publish_every: int = 8       # replica batches between checkpoint publishes
    queue_depth: int = 8         # bounded command queue / outstanding acks
    ack_timeout: float = 30.0    # silence budget before a health probe
    ping_timeout: float = 5.0    # probe budget before declaring death
    backoff: float = 0.02        # initial retry backoff (doubles per retry)
    max_backoff: float = 0.5
    max_restarts: int = 5        # per-replica restart budget per run
    # spawn + torch import + CUDA context + restore budget
    start_timeout: float = 180.0
    # env forced into replica processes (spawn inherits os.environ)
    child_env: Tuple[Tuple[str, str], ...] = ()
    # wire codec for published checkpoints (repro_torch.distributed.codecs):
    # replicas commit ENCODED leaves (CRC over encoded bytes), the
    # coordinator restores+decodes before the merge.  Seed/key leaves stay
    # lossless under every codec, so the corrupt-shard and seed-guard
    # rejection contracts are codec-independent.
    codec: str = "none"
    # where the replicas and the coordinator's reference engine hold their
    # states: the card unless the caller asks otherwise ("cpu")
    device: Optional[str] = None


class FleetStats:
    """Coordinator-side counters + per-route latencies (seconds)."""

    def __init__(self):
        self.restarts = 0       # replica respawns (kill/hang recoveries)
        self.retries = 0        # backpressure/backoff retries on full queues
        self.probes = 0         # health pings issued
        self.routed_batches = 0  # non-empty per-replica blocks dispatched
        self.routed_events = 0   # per-stream elements routed (sum of n)
        self.route_s: list = []  # wall-clock per route() call
        self.publishes = 0       # confirmed checkpoint publishes
        self.published_bytes = 0  # wire bytes across all publishes (encoded)
        self.start_s: list = []  # spawn -> ready, every replica process
        self.recover_s: list = []  # kill + respawn + replay, per recovery
        # kernel launches summed over the replica processes, as each
        # reports them with its publishes and its stop
        self.replica_launches: dict = {}

    def latency_percentile(self, q: float) -> float:
        if not self.route_s:
            return 0.0
        return float(np.percentile(np.asarray(self.route_s, np.float64), q))


# ---------------------------------------------------------------------------
# replica process
# ---------------------------------------------------------------------------

def _replica_main(rid: int, ecfg, plane: str, ckpt_dir: str, cmd_q, out_q,
                  fault: FaultPlan, codec: str = "none", device=None,
                  deterministic: Tuple[bool, bool] = (False, False)) -> None:
    """One replica: a SketchEngine shard behind a command queue.

    ``deterministic`` is the coordinator's ``(use_deterministic_algorithms,
    warn_only)``, set before the engine is built: the mode is global to a
    process and a spawned child starts with it off.  ``flush_elems=1``
    dispatches every routed block at its own boundary -- the granularity of
    the in-process ``FleetPlane`` sub-planes.  On start the replica restores
    its newest COMMITTED checkpoint onto its device (crash recovery) and
    reports the restored step so the coordinator can replay exactly the
    journal suffix past it.  Its ``published`` and ``stopped`` messages
    carry its kernel launch counts; its ready message the seconds from
    entry (past the process start and imports) to ready: the device
    context, the engine and the restore.
    """
    from repro_torch.engine.engine import SketchEngine

    t_entry = time.monotonic()
    # the flag that torch.use_deterministic_algorithms sets, without that
    # function's import of torch._inductor.config: it mirrors the flag for
    # compiled graphs, which the port does not run, and costs seconds of a
    # cold replica's start (the ready message's init_s)
    torch._C._set_deterministic_algorithms(deterministic[0],
                                           warn_only=deterministic[1])
    eng = SketchEngine(ecfg, plane=plane, flush_elems=1, device=device)
    applied = 0  # seq of the last applied ingest (0 = nothing yet)
    checkpoint.gc_tmp(ckpt_dir)
    restored, step = checkpoint.restore_latest(ckpt_dir, eng.state,
                                               device=eng.device)
    if restored is not None:
        eng.state = restored
        applied = int(step)
    out_q.put(("ready", applied, {
        "pid": os.getpid(), "device": str(eng.device),
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "init_s": time.monotonic() - t_entry}))
    n_since_plan = 0
    while True:
        cmd = cmd_q.get()
        op = cmd[0]
        if op == "stop":
            out_q.put(("stopped", launch_counts()))
            return
        if op == "ping":
            out_q.put(("pong", cmd[1]))
        elif op == "fault":
            fault = cmd[1]
            n_since_plan = 0
            out_q.put(("fault_set",))
        elif op == "ingest":
            _, seq, keys, vals = cmd
            n_since_plan += 1
            if fault.delay_s:
                time.sleep(fault.delay_s)
            if (fault.hang_after is not None
                    and n_since_plan > fault.hang_after):
                time.sleep(_HANG_S)  # unresponsive: the probe must kill us
                continue
            eng.ingest(keys, vals)
            applied = seq
            if (fault.kill_after is not None
                    and n_since_plan >= fault.kill_after):
                # abrupt death AFTER applying, BEFORE acking/committing:
                # the in-memory state is lost wholesale, so recovery =
                # restored checkpoint + journal replay applies this block
                # exactly once
                os._exit(_KILL_EXIT)
            out_q.put(("ack", seq))
        elif op == "publish":
            eng.flush()
            st = eng.state
            if fault.publish_wrong_seed:
                rogue = SketchEngine(
                    ecfg._replace(seed=int(ecfg.seed) ^ 0x0BAD5EED),
                    device=eng.device)
                st = rogue.state
            path = checkpoint.save(ckpt_dir, applied, st, codec=codec)
            if fault.corrupt_publish:
                _flip_committed_byte(path)
            # the confirmation carries the wire size of the committed
            # (encoded) payload and the replica's kernel launches so far
            out_q.put(("published", applied, checkpoint.payload_nbytes(path),
                       launch_counts()))
        else:
            out_q.put(("error", f"unknown command {op!r}"))


# ---------------------------------------------------------------------------
# coordinator (router + merge protocol)
# ---------------------------------------------------------------------------

class _Replica:
    """Coordinator-side handle: process, queues, journal, protocol state."""

    def __init__(self, rid: int, ckpt_dir: str):
        self.rid = rid
        self.ckpt_dir = ckpt_dir
        self.proc = None
        self.cmd_q = None
        self.out_q = None
        self.journal: list = []       # [(seq, keys, vals)] not yet published
        self.outstanding = collections.deque()  # expected responses, FIFO
        self.applied = 0              # highest seq the replica confirmed
        self.published = 0            # step of the last confirmed publish
        self.since_publish = 0
        self.restarts = 0
        self.pong = None              # token of the last pong received
        self.launched_at = 0.0        # monotonic time of the last spawn
        self.info: dict = {}          # the ready message's pid/device/mode
        self.counts: dict = {}        # this process's last launch report


@contextlib.contextmanager
def _forced_env(pairs: Sequence[Tuple[str, str]]):
    """Temporarily force env vars around a child spawn (the child inherits
    os.environ at Process.start); pre-existing values win."""
    added = []
    for key, val in pairs:
        if key not in os.environ:
            os.environ[key] = val
            added.append(key)
    try:
        yield
    finally:
        for key in added:
            os.environ.pop(key, None)


def _discard_queue(q) -> None:
    """Drop a dead replica's queue without letting its feeder thread block
    interpreter/coordinator teardown on an orphaned pipe."""
    if q is None:
        return
    try:
        q.cancel_join_thread()
        q.close()
    except Exception:
        pass


class FleetCoordinator:
    """Owns R replica processes: routes, probes, recovers, merges.

    Lifecycle: ``start()`` (or use as a context manager), ``route()`` per
    microbatch, ``sample(k)`` / ``merged_state()`` at read points,
    ``stop()``.  ``faults`` maps replica id -> FaultPlan installed at spawn;
    ``inject_fault`` scripts faults mid-stream.  All recovery is internal --
    callers only see ``stats.restarts`` move -- except an unmergeable
    published shard, which raises at the merge boundary by design.
    Replicas are always started with ``spawn``: a process that has
    initialised CUDA is never forked.
    """

    def __init__(self, cfg: FleetConfig, root: Optional[str] = None,
                 faults: Optional[dict] = None):
        from repro_torch.engine.engine import SketchEngine

        if cfg.replicas < 1:
            raise ValueError(f"fleet needs replicas >= 1, got {cfg.replicas}")
        if cfg.plane in ("fleet",):
            raise ValueError("fleet replicas cannot nest the fleet plane")
        self.cfg = cfg
        self._faults = dict(faults or {})
        self._ctx = multiprocessing.get_context("spawn")
        self._seq = 0
        self.stats = FleetStats()
        # local reference engine: like-trees for restore, merge/sample ops;
        # it never ingests, so it is NOT a hidden (R+1)-th shard
        self._ref = SketchEngine(cfg.engine, device=cfg.device)
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="repro-torch-fleet-")
        self._replicas = [
            _Replica(r, os.path.join(self.root, f"replica_{r:02d}"))
            for r in range(cfg.replicas)]
        self._started = False

    @property
    def replica_info(self) -> list:
        """Each replica's ready report: its pid, device, whether the
        deterministic mode is on in its process, and its ``init_s``."""
        return [dict(r.info) for r in self._replicas]

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self):
        try:
            self.start()
        except BaseException:
            self.stop()
            raise
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        if self._started:
            return self
        # launch all replicas before waiting on any: startup cost is one
        # process spawn + torch import + CUDA context, paid once in
        # parallel, not R times
        for r in self._replicas:
            self._launch(r, self._faults.get(r.rid, FaultPlan()))
        for r in self._replicas:
            self._wait_ready(r)
        self._started = True
        return self

    def stop(self):
        for r in self._replicas:
            if r.proc is None:
                continue
            if r.proc.is_alive():
                try:
                    r.cmd_q.put(("stop",), timeout=1.0)
                except queue.Full:
                    pass
                self._await_stopped(r, timeout=10.0)
            r.proc.join(timeout=10.0)
            if r.proc.is_alive():
                r.proc.terminate()
                r.proc.join(timeout=10.0)
            if r.proc.is_alive():
                r.proc.kill()
                r.proc.join(timeout=10.0)
            _discard_queue(r.cmd_q)
            _discard_queue(r.out_q)
            r.proc = None
        self._started = False
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def _await_stopped(self, r: _Replica, timeout: float) -> None:
        """Read a stopping replica's responses until its ``stopped`` report
        (its final launch counts), its death, or ``timeout``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                msg = r.out_q.get(timeout=0.05)
            except queue.Empty:
                if not r.proc.is_alive():
                    return
                continue
            if msg[0] == "stopped":
                self._tally(r, msg[1])
                return
            if msg[0] == "published" and len(msg) > 3:
                self._tally(r, msg[3])

    def _tally(self, r: _Replica, counts: dict) -> None:
        """Fold a replica's cumulative launch report into the fleet's sums
        (a respawned process counts from zero)."""
        total = self.stats.replica_launches
        for key, n in counts.items():
            total[key] = total.get(key, 0) + int(n) - r.counts.get(key, 0)
        r.counts = dict(counts)

    def _launch(self, r: _Replica, fault: FaultPlan) -> None:
        r.cmd_q = self._ctx.Queue(maxsize=self.cfg.queue_depth)
        r.out_q = self._ctx.Queue()
        r.counts = {}
        mode = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
        r.proc = self._ctx.Process(
            target=_replica_main,
            args=(r.rid, self.cfg.engine, self.cfg.plane, r.ckpt_dir,
                  r.cmd_q, r.out_q, fault, self.cfg.codec, self.cfg.device,
                  mode),
            name=f"repro-torch-fleet-replica-{r.rid}", daemon=True)
        r.launched_at = time.monotonic()
        with _forced_env(self.cfg.child_env):
            r.proc.start()

    def _wait_ready(self, r: _Replica) -> None:
        deadline = time.monotonic() + self.cfg.start_timeout
        while True:
            try:
                msg = r.out_q.get(timeout=1.0)
            except queue.Empty:
                if not r.proc.is_alive() or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"fleet replica {r.rid} failed to start "
                        f"(alive={r.proc.is_alive()}, exit code "
                        f"{r.proc.exitcode})")
                continue
            if msg[0] == "ready":
                break
        self.stats.start_s.append(time.monotonic() - r.launched_at)
        r.info = dict(msg[2]) if len(msg) > 2 else {}
        # the replica restored its newest committed checkpoint: protocol
        # state resets to that point; everything past it must be replayed
        r.applied = r.published = int(msg[1])
        r.outstanding = collections.deque()
        r.since_publish = 0

    def _spawn(self, r: _Replica, fault: FaultPlan) -> None:
        self._launch(r, fault)
        self._wait_ready(r)

    # -- routing ------------------------------------------------------------
    def route(self, keys, values):
        """Route one (B, n) turnstile microbatch: partition sticky by key
        hash (deletions land on the replica that saw the insertions),
        journal each non-empty block, dispatch with bounded backpressure."""
        if not self._started:
            raise RuntimeError("fleet not started (use start() or `with`)")
        t0 = time.perf_counter()
        keys = np.asarray(keys, np.int32)
        values = np.asarray(values, np.float32)
        parts = planes.partition_by_key(keys, values, self.cfg.replicas)
        for r, (k, v) in zip(self._replicas, parts):
            if not k.shape[1]:
                continue  # no seq consumed: replicas see only their blocks
            self._seq += 1
            r.journal.append((self._seq, k, v))
            self.stats.routed_batches += 1
            self.stats.routed_events += int(k.shape[1])
            if self._send(r, ("ingest", self._seq, k, v),
                          expect=("ack", self._seq)):
                r.since_publish += 1
                # bounded pipeline: never run more than queue_depth acks
                # ahead of the replica
                self._await_outstanding(r, limit=self.cfg.queue_depth)
            if r.since_publish >= self.cfg.publish_every:
                self._publish(r)
        self.stats.route_s.append(time.perf_counter() - t0)
        return self

    def inject_fault(self, rid: int, fault: FaultPlan) -> None:
        """Install a FaultPlan in a RUNNING replica (scripted chaos); the
        plan's ingest counters restart from this point in the stream."""
        r = self._replicas[rid]
        if self._send(r, ("fault", fault), expect=("fault_set",)):
            self._await_outstanding(r, limit=0)

    def _publish(self, r: _Replica) -> None:
        """Fire-and-track publish: the 'published' confirmation drains with
        the other outstanding responses (journal trimming happens there)."""
        if self._send(r, ("publish",), expect=("publish",)):
            r.since_publish = 0

    # -- merge protocol -----------------------------------------------------
    def publish_all(self):
        """Drive every replica to a committed checkpoint covering its whole
        routed stream (recovering and retrying as needed)."""
        for r in self._replicas:
            for _ in range(self.cfg.max_restarts + 2):
                if not self._await_outstanding(r, limit=0):
                    continue  # recovered mid-wait: journal was replayed
                # always re-publish (even when nothing new was applied): a
                # fresh commit at the same step overwrites any unreadable
                # artifact a since-cleared fault left behind
                if not self._send(r, ("publish",), expect=("publish",)):
                    continue
                if not self._await_outstanding(r, limit=0):
                    continue
                break
            else:
                raise RuntimeError(
                    f"replica {r.rid} failed to publish within the restart "
                    f"budget ({self.cfg.max_restarts})")
        return self

    def merged_state(self):
        """Publish, restore onto the coordinator's device, and collapse
        every replica shard.

        Rejection is the contract here: a corrupted shard fails its CRC32
        (IOError from ``checkpoint.restore``) and a shard published under
        different seeds fails the merge-tree seed guard (ValueError from
        ``sharding.merge_states``) -- neither is ever silently merged.
        """
        self.publish_all()
        states = []
        for r in self._replicas:
            step = checkpoint.latest_step(r.ckpt_dir)
            if step is None:
                raise RuntimeError(
                    f"replica {r.rid} has no committed checkpoint")
            states.append(checkpoint.restore(r.ckpt_dir, step,
                                             self._ref.state,
                                             device=self._ref.device))
        return shd.merge_states(states, self._ref.merge_fn)

    def sample(self, k: int):
        """Aggregated per-stream WOR sample over the union of all routed
        traffic (the quantity held bitwise-equal to the single-process
        reference by the chaos tests)."""
        return self._ref.sample_state(self.merged_state(), k)

    # -- health / transport -------------------------------------------------
    def _send(self, r: _Replica, msg, expect=None) -> bool:
        """Enqueue with bounded backpressure: retry with exponential
        backoff while the command queue is full, probe after the silence
        budget, recover on a failed probe.  Returns False when the replica
        was recovered instead (journaled work was replayed; non-journaled
        commands are the caller's to retry)."""
        backoff = self.cfg.backoff
        deadline = time.monotonic() + self.cfg.ack_timeout
        while True:
            if not r.proc.is_alive():
                self._recover(r)
                return False
            try:
                r.cmd_q.put(msg, timeout=backoff)
            except queue.Full:
                self.stats.retries += 1
                self._pump(r)
                backoff = min(backoff * 2.0, self.cfg.max_backoff)
                if time.monotonic() > deadline:
                    if self._probe(r):
                        deadline = time.monotonic() + self.cfg.ack_timeout
                    else:
                        self._recover(r)
                        return False
                continue
            if expect is not None:
                r.outstanding.append(expect)
            return True

    def _pump(self, r: _Replica) -> None:
        while True:
            try:
                msg = r.out_q.get_nowait()
            except queue.Empty:
                return
            self._apply_msg(r, msg)

    def _apply_msg(self, r: _Replica, msg) -> None:
        kind = msg[0]
        if kind == "ack":
            r.applied = max(r.applied, int(msg[1]))
            if r.outstanding and r.outstanding[0] == ("ack", msg[1]):
                r.outstanding.popleft()
        elif kind == "published":
            r.published = max(r.published, int(msg[1]))
            if len(msg) > 2:  # wire bytes of the committed encoded payload
                self.stats.publishes += 1
                self.stats.published_bytes += int(msg[2])
            if len(msg) > 3:  # the replica's kernel launches so far
                self._tally(r, msg[3])
            # the journal only needs to cover un-committed suffix
            r.journal = [e for e in r.journal if e[0] > r.published]
            if r.outstanding and r.outstanding[0][0] == "publish":
                r.outstanding.popleft()
        elif kind == "pong":
            r.pong = msg[1]
            if r.outstanding and r.outstanding[0] == ("pong", msg[1]):
                r.outstanding.popleft()
        elif kind == "fault_set":
            if r.outstanding and r.outstanding[0][0] == "fault_set":
                r.outstanding.popleft()
        elif kind == "error":
            raise RuntimeError(f"replica {r.rid}: {msg[1]}")
        # "ready"/"stopped" are handled at spawn/stop boundaries

    def _await_outstanding(self, r: _Replica, limit: int = 0) -> bool:
        """Pump responses until at most ``limit`` remain outstanding.
        Health-aware: silence past ack_timeout triggers a probe; a failed
        probe (or a dead process) triggers recovery.  Returns False when
        the replica was recovered (outstanding reset by the respawn)."""
        deadline = time.monotonic() + self.cfg.ack_timeout
        while len(r.outstanding) > limit:
            try:
                msg = r.out_q.get(timeout=0.05)
            except queue.Empty:
                if not r.proc.is_alive():
                    self._recover(r)
                    return False
                if time.monotonic() > deadline:
                    if self._probe(r):
                        deadline = time.monotonic() + self.cfg.ack_timeout
                    else:
                        self._recover(r)
                        return False
                continue
            self._apply_msg(r, msg)
            deadline = time.monotonic() + self.cfg.ack_timeout
        return True

    def _probe(self, r: _Replica) -> bool:
        """Ping through the command FIFO and wait for the matching pong
        (FIFO ordering means the pong also certifies every command ahead
        of it was serviced).  Any arriving message extends the probe --
        a backlogged-but-alive replica is making progress, not dead."""
        self.stats.probes += 1
        if not r.proc.is_alive():
            return False
        token = f"probe-{self.stats.probes}"
        try:
            r.cmd_q.put_nowait(("ping", token))
        except queue.Full:
            return False  # wedged: queue full AND the silence budget spent
        r.outstanding.append(("pong", token))
        deadline = time.monotonic() + self.cfg.ping_timeout
        while time.monotonic() < deadline:
            try:
                msg = r.out_q.get(timeout=0.05)
            except queue.Empty:
                if not r.proc.is_alive():
                    return False
                continue
            self._apply_msg(r, msg)
            if r.pong == token:
                return True
            deadline = time.monotonic() + self.cfg.ping_timeout
        return False

    def _recover(self, r: _Replica) -> None:
        """Kill (if needed), respawn clean, restore, replay.

        The respawned replica restores its last COMMITTED checkpoint and
        reports that step as ``ready``; the coordinator then replays
        exactly the journal suffix past it.  One-shot faults: the fresh
        process gets an empty FaultPlan."""
        if r.restarts >= self.cfg.max_restarts:
            raise RuntimeError(
                f"replica {r.rid} exceeded the restart budget "
                f"({self.cfg.max_restarts}); giving up")
        t0 = time.monotonic()
        r.restarts += 1
        self.stats.restarts += 1
        if r.proc is not None and r.proc.is_alive():
            r.proc.terminate()
            r.proc.join(timeout=10.0)
            if r.proc.is_alive():
                r.proc.kill()
                r.proc.join(timeout=10.0)
        _discard_queue(r.cmd_q)
        _discard_queue(r.out_q)
        self._spawn(r, FaultPlan())
        replay = [e for e in r.journal if e[0] > r.applied]
        for seq, k, v in replay:
            if self._send(r, ("ingest", seq, k, v), expect=("ack", seq)):
                self._await_outstanding(r, limit=self.cfg.queue_depth)
        r.since_publish = len(replay)
        self.stats.recover_s.append(time.monotonic() - t0)


# ---------------------------------------------------------------------------
# the in-process reference: the "fleet" data plane
# ---------------------------------------------------------------------------

@planes.register_plane("fleet")
class FleetPlane(planes.PipelinePlane):
    """The pipeline's router (``partition_by_key`` across ``replicas``
    sub-planes, each dispatching per forwarded block), but every collapse
    runs the merge protocol: each replica state is published through a
    ``train.checkpoint`` save/restore round-trip (atomic commit, per-leaf
    CRC32) into a scratch directory, then reduced with
    ``sharding.merge_states`` under the seed guards.  At R = 2 the
    collapse equals the pipeline's bit for bit (the round-trip is an
    identity under ``none``; the butterfly of two is the pipeline's fold).
    """

    def __init__(self, spec, state, policy=None, replicas: int = 2,
                 subplane: str = "sparse", codec: str = "none"):
        if subplane == "fleet":
            raise ValueError("fleet sub-planes cannot nest")
        super().__init__(spec, state, policy=policy, shards=replicas,
                         subplane=subplane, codec=codec)
        self.replicas = self.shards
        self._scratch: Optional[str] = None

    def _scratch_dir(self) -> str:
        if self._scratch is None:
            self._scratch = tempfile.mkdtemp(prefix="repro-torch-fleet-")
            weakref.finalize(self, shutil.rmtree, self._scratch,
                             ignore_errors=True)
        return self._scratch

    def _publish_roundtrip(self, shard: int, st):
        """One replica publish: commit + CRC-verified restore onto the
        plane's device (step 0 is overwritten per collapse, so scratch
        usage stays bounded).  With a lossy codec the commit stores the
        ENCODED leaves, so this crossing is the wire."""
        d = os.path.join(self._scratch_dir(), f"replica_{shard:02d}")
        checkpoint.save(d, 0, st, codec=self.codec)
        return checkpoint.restore(d, 0, st, device=self.device)

    @property
    def state(self):
        """The collapsed state via the checkpoint merge protocol."""
        self._settle()
        if self._merged is None:
            published = [self._publish_roundtrip(i, sub.state)
                         for i, sub in enumerate(self._subplanes)]
            # no codec here: the publish round-trip above IS the wire
            # crossing; a second application would quantize twice
            self._merged = shd.merge_states(published, self._merge)
        return self._merged

    def close(self):
        super().close()
        if self._scratch is not None:
            shutil.rmtree(self._scratch, ignore_errors=True)
            self._scratch = None


def reference_sample(ecfg, batches, replicas: int, k: int,
                     subplane: str = "sparse", codec: str = "none",
                     device=None):
    """Single-process reference for a fleet run: feed the microbatch stream
    through the ``fleet`` plane (identical routing, dispatch granularity
    and merge protocol, the wire codec included) and sample once."""
    from repro_torch.engine.engine import SketchEngine

    eng = SketchEngine(ecfg, flush_elems=1, plane="fleet", device=device,
                       plane_opts={"replicas": replicas,
                                   "subplane": subplane, "codec": codec})
    try:
        for keys, vals in batches:
            eng.ingest(keys, vals)
        return eng.sample(k)
    finally:
        eng.plane.close()


__all__ = [
    "FaultPlan",
    "FleetConfig",
    "FleetCoordinator",
    "FleetPlane",
    "FleetStats",
    "reference_sample",
]
