"""Data planes: how host-side turnstile microbatches reach sampler state.

Every plane shares one host-buffer discipline -- sparse signed
``(keys, values)`` microbatches accumulate as numpy arrays (no device work)
until a ``FlushPolicy`` fires -- and they differ only in the dispatch step:

  ``DensePlane``    the sampler spec's plain PyTorch update on the
                    concatenated batch (the reference plane).
  ``SparsePlane``   ``ingest_sparse``: every sketch-backed sampler takes
                    its registered kernel path (the sampler-name registry
                    below): scatter-kernel launches for the sketch deltas,
                    then estimate-kernel launches for the candidate refresh
                    (and the two-pass buffer's online priorities).  The
                    perfect oracle, which holds no sketch, takes its spec's
                    update.  Dispatch is inline at the flush boundary.
  ``AsyncPlane``    double-buffered ingest: each flush batch is handed to
                    one worker thread, which copies it to the card,
                    dispatches it on a CUDA stream of its own and waits for
                    it before publishing the new state, while the producer
                    fills the next batch.  Dispatch boundaries are decided
                    on the producer side, so the dispatch sequence is the
                    synchronous plane's: under
                    ``torch.use_deterministic_algorithms(True)`` (every sum
                    of a flush in a fixed order, the scatter's "det"
                    variant included) its drained state and samples equal
                    ``SparsePlane``'s bit for bit, on the card as on the
                    CPU.  With the mode off the scatter's atomics sum in a
                    varying order, and the two agree within the summing
                    tolerances.
  ``PipelinePlane`` per-shard + collapse: each flushed batch is partitioned
                    by key hash across S sub-planes (sparse or async) that
                    start from the same state, and every state read merges
                    the shard states through the sampler's merge.  Its
                    contract against a single plane is the summing
                    tolerances and the same samples; async sub-planes equal
                    sparse sub-planes bit for bit (in the deterministic mode
                    on the card).

``FlushPolicy`` fires on pending elements, bytes, or the age of the oldest
pending microbatch (``max_interval``).  The first two depend only on the
data, so dispatch boundaries are reproducible; the interval is wall-clock
and trades that away.  The synchronous planes test it at ingest time;
``AsyncPlane`` also arms a timer, so an idle producer's tail is published
within the interval on its own.

Planes are registered by name (``register_plane``, ``make_plane``,
``available_planes``); ``"ingest"`` is an alias of ``"sparse"``.  The
``fleet`` plane (``repro_torch.distributed.fleet``: the pipeline's routing,
collapsed through the checkpoint merge protocol) registers last, so the
order is (dense, sparse, async, pipeline, fleet).

Wire codecs (``repro_torch.distributed.codecs``): ``codec=`` names the
codec a plane's state crosses boundaries under.  ``FlushPolicy.max_bytes``
budgets the pending microbatches' WIRE bytes under it (int32 keys raw,
float32 values encoded; with ``none`` the raw bytes), and the pipeline's
collapse roundtrips each shard state through it once before merging.
"""
from __future__ import annotations

import atexit
import contextlib
import queue
import threading
import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import countsketch, hashing, transforms, tv_sampler, worp
from repro_torch.core import sampler as core_sampler
from repro_torch.core.sampler import SamplerSpec
from repro_torch.distributed import codecs as wire_codecs
from repro_torch.engine.engine import (  # noqa: F401  (batched_ops: the
    _MERGES, _leaves, _refresh_candidates, batched_ops)  # reference's name)
from repro_torch.kernels import ops, tiling
from repro_torch.trace import span

# ---------------------------------------------------------------------------
# sparse kernel paths by sampler name: a sampler opts into the scatter-kernel
# plane with ``@register_sparse_path(name)`` (signature
# ``fn(state, keys, values, p, scheme)``).  ``register_frozen_sketch``
# likewise exposes the pass-II frozen CountSketch for the batched-priority
# path of ``SketchEngine.update_pass2``.
# ---------------------------------------------------------------------------

_SPARSE_PATHS: dict = {}
_FROZEN_SKETCH: dict = {}


def register_sparse_path(name: str):
    def deco(fn):
        _SPARSE_PATHS[name] = fn
        return fn

    return deco


def register_frozen_sketch(name: str):
    def deco(fn):
        _FROZEN_SKETCH[name] = fn
        return fn

    return deco


register_frozen_sketch("onepass")(lambda st: st.sketch)
register_frozen_sketch("twopass")(lambda st: st.pass1.sketch)


def frozen_sketch_getter(name: str):
    """The registered frozen pass-I sketch accessor for ``name`` (None when
    the sampler registered none)."""
    return _FROZEN_SKETCH.get(name)


@register_sparse_path("onepass")
def onepass_update_sparse(st: worp.OnePassState, keys: torch.Tensor,
                          values: torch.Tensor, p: float,
                          scheme: str = transforms.PPSWOR):
    """Turnstile fast path: B sparse signed batches through one scatter
    launch, then the candidate refresh of (C + n) keys per stream through
    one estimate-kernel launch.

    ``(keys[b, i], values[b, i])`` is a signed update of stream b (negative
    values are deletions); ``keys == -1`` slots are padding.  The same
    result as ``worp.onepass_update`` on the batch, up to float summation
    order."""
    with span("sparse.scatter"):
        delta = ops.sketch_sparse_batch(
            keys, values, st.sketch.rows, st.sketch.width, st.sketch.seed,
            p=p, scheme=scheme, transform_seeds=st.seed_transform)
        sk = countsketch.CountSketch(table=st.sketch.table + delta,
                                     seed=st.sketch.seed)
    with span("sparse.refresh"):
        cand = _refresh_candidates(sk, st.cand_keys, keys)
    return worp.OnePassState(sketch=sk, cand_keys=cand,
                             seed_transform=st.seed_transform)


# the core function takes the stream axis natively
twopass_update_from_priorities_batched = worp.twopass_update_from_priorities


@register_sparse_path("twopass")
def twopass_run_update_sparse(st, keys: torch.Tensor, values: torch.Tensor,
                              p: float, scheme: str = transforms.PPSWOR):
    """Sparse kernel path of the streaming "twopass" state
    (``core.sampler.TwoPassRunState``): pass I is the one-pass path (one
    scatter launch, one estimate launch for its refresh); the pass-II
    buffer's online priorities of the batch keys are one more estimate
    launch."""
    p1 = onepass_update_sparse(st.pass1, keys, values, p, scheme)
    with span("sparse.refresh"):
        prio = ops.estimate_batched(p1.sketch.table, keys, p1.sketch.seed)
        p2 = twopass_update_from_priorities_batched(st.pass2, keys, values,
                                                    prio)
    return core_sampler.TwoPassRunState(pass1=p1, pass2=p2)


@register_sparse_path("tv")
def tv_update_sparse(st: tv_sampler.TVSamplerState, keys: torch.Tensor,
                     values: torch.Tensor, p: float,
                     scheme: str = transforms.PPSWOR):
    """Sparse kernel path of the batched TV cascade: the B x r cascade
    sketches (each with its own hash and transform seed) flatten into one
    scatter launch, their candidate refresh into one estimate launch, and
    the rHH takes the one-pass path."""
    B, r = st.transform_seeds.shape
    rows, width = st.sketches.table.shape[-2:]
    C = st.cand_keys.shape[-1]
    flat_seeds = st.sketches.seed.reshape(B * r)
    # stream b feeds all r of its cascade samplers
    keys_f = keys.repeat_interleave(r, 0)
    vals_f = values.repeat_interleave(r, 0)
    with span("sparse.scatter"):
        delta = ops.sketch_sparse_batch(
            keys_f, vals_f, rows, width, flat_seeds, p=p, scheme=scheme,
            transform_seeds=st.transform_seeds.reshape(B * r))
        tables = st.sketches.table.reshape(B * r, rows, width) + delta
        del delta
    with span("sparse.refresh"):
        cand = _refresh_candidates(
            countsketch.CountSketch(table=tables, seed=flat_seeds),
            st.cand_keys.reshape(B * r, C), keys_f)
    del keys_f, vals_f
    return tv_sampler.TVSamplerState(
        sketches=countsketch.CountSketch(
            table=tables.reshape(B, r, rows, width), seed=st.sketches.seed),
        cand_keys=cand.reshape(B, r, C),
        transform_seeds=st.transform_seeds,
        rhh=onepass_update_sparse(st.rhh, keys, values, p, scheme))


def _holds_sketch(state) -> bool:
    if isinstance(state, countsketch.CountSketch):
        return True
    return isinstance(state, tuple) and any(_holds_sketch(f) for f in state)


def ingest_sparse(spec: SamplerSpec, state, keys, values):
    """Route one batched sparse signed update through the sampler's kernel
    path.  A sampler with no sketch (the perfect oracle) takes its spec's
    update; a sketch-backed sampler without a registered path raises."""
    path = _SPARSE_PATHS.get(spec.name)
    if path is not None:
        return path(state, keys, values, spec.cfg.p, spec.cfg.scheme)
    if _holds_sketch(state):
        raise NotImplementedError(
            f"sampler {spec.name!r} holds a sketch but has no sparse kernel "
            f"path; registered: {sorted(_SPARSE_PATHS)}")
    return spec.update(state, keys, values)


# ---------------------------------------------------------------------------
# flush policy
# ---------------------------------------------------------------------------

class FlushPolicy(NamedTuple):
    """When does the host buffer dispatch?  Any trigger that is not None
    fires the flush once reached.  The element and byte triggers depend only
    on the ingested data, so dispatch boundaries are reproducible;
    ``max_interval`` (seconds since the oldest pending microbatch) is
    wall-clock and trades that for age-bounded batches.  The synchronous
    planes test it at ingest time (an aged buffer dispatches on the next
    ``ingest``, or any read, which drains); ``AsyncPlane`` also arms a
    timer, so an idle producer's tail is published within the interval."""

    max_elems: Optional[int] = 4096   # per-stream pending element count
    max_bytes: Optional[int] = None   # pending host-buffer bytes (keys+vals)
    max_interval: Optional[float] = None  # seconds since first pending batch

    def should_flush(self, elems: int, nbytes: int, age: float) -> bool:
        if self.max_elems is not None and elems >= self.max_elems:
            return True
        if self.max_bytes is not None and nbytes >= self.max_bytes:
            return True
        if self.max_interval is not None and age >= self.max_interval:
            return True
        return False


# ---------------------------------------------------------------------------
# plane registry
# ---------------------------------------------------------------------------

_PLANES: dict = {}


def register_plane(name: str, *aliases: str):
    """Register a DataPlane subclass under ``name`` (and any aliases)."""

    def deco(cls):
        cls.name = name
        for key in (name, *aliases):
            _PLANES[key] = cls
        return cls

    return deco


def available_planes() -> tuple:
    """Registered plane names, aliases left out, in registration order."""
    return tuple(dict.fromkeys(cls.name for cls in _PLANES.values()))


def make_plane(name: str, spec: SamplerSpec, state,
               policy: Optional[FlushPolicy] = None,
               **plane_opts) -> "DataPlane":
    """Instantiate a registered plane over ``spec`` and its batched state
    (which lives on the device the plane dispatches to).  ``plane_opts``
    are the plane's own keywords (``shards=``/``subplane=`` for
    ``"pipeline"``); a plane that takes none rejects them."""
    cls = _PLANES.get(name)
    if cls is None:
        raise ValueError(f"unknown data plane {name!r}; registered planes: "
                         f"{sorted(set(_PLANES))}")
    return cls(spec, state, policy=policy, **plane_opts)


# ---------------------------------------------------------------------------
# the planes
# ---------------------------------------------------------------------------

def _concat_rows(parts: list) -> np.ndarray:
    """The (B, n) microbatches joined along their columns into a new
    C-contiguous array, the layout the kernels take.  (``np.concatenate``
    follows its inputs' strides: broadcast views, such as the ingest
    pipeline's packed blocks, would give a Fortran-ordered result.)"""
    out = np.empty((parts[0].shape[0], sum(p.shape[1] for p in parts)),
                   parts[0].dtype)
    return np.concatenate(parts, axis=1, out=out)


class DataPlane:
    """Shared host-buffer discipline; subclasses define ``_dispatch``.

    The plane owns the batched sampler state while ingest is in progress.
    ``state`` settles in-flight work (the async plane's) but does not flush
    the host buffer; ``drain()`` does both, and is what every read/merge
    boundary calls (``SketchEngine`` does)."""

    name = "abstract"

    def __init__(self, spec: SamplerSpec, state,
                 policy: Optional[FlushPolicy] = None, codec: str = "none"):
        self.spec = spec
        # the wire codec this plane's state crosses boundaries under; the
        # byte budget counts the pending microbatches as it encodes them
        self.codec = wire_codecs.get_codec(codec)
        self.policy = policy if policy is not None else FlushPolicy()
        self.device = _leaves(state)[0].device
        self._state = state
        self._buf_keys: list = []
        self._buf_vals: list = []
        self._buf_elems = 0
        self._buf_bytes = 0
        self._buf_t0: Optional[float] = None

    def _dispatch(self, state, keys: torch.Tensor, values: torch.Tensor):
        raise NotImplementedError

    def ingest(self, keys, values):
        """Buffer one sparse signed (B, n) microbatch; dispatch when the
        flush policy fires.  Bytes count the wire bytes of the int32 keys
        and float32 values under the plane's codec."""
        keys = np.asarray(keys, np.int32)
        values = np.asarray(values, np.float32)
        self._buf_keys.append(keys)
        self._buf_vals.append(values)
        self._buf_elems += keys.shape[1]
        self._buf_bytes += self._wire_bytes(keys, values)
        if self._buf_t0 is None:
            self._buf_t0 = time.monotonic()
        if self.policy.should_flush(self._buf_elems, self._buf_bytes,
                                    time.monotonic() - self._buf_t0):
            self._flush_buffer()
        return self

    def _wire_bytes(self, keys: np.ndarray, values: np.ndarray) -> int:
        return (self.codec.payload_nbytes(keys)
                + self.codec.payload_nbytes(values))

    @property
    def pending(self) -> int:
        """Per-stream element count buffered on the host (a batch handed to
        the async plane's worker is no longer pending)."""
        return self._buf_elems

    @property
    def pending_bytes(self) -> int:
        return self._buf_bytes

    def _concat_buffer(self):
        with span("plane.concat"):
            return (_concat_rows(self._buf_keys),
                    _concat_rows(self._buf_vals))

    def _clear_buffer(self):
        self._buf_keys, self._buf_vals = [], []
        self._buf_elems = self._buf_bytes = 0
        self._buf_t0 = None

    def _apply(self, state, keys: np.ndarray, vals: np.ndarray):
        """One concatenated batch to the device and through ``_dispatch``:
        the ``plane.h2d`` and ``plane.dispatch`` ranges, on the thread that
        runs them."""
        with span("plane.h2d"):
            keys = torch.from_numpy(keys).to(self.device)
            vals = torch.from_numpy(vals).to(self.device)
        with span("plane.dispatch"):
            return self._dispatch(state, keys, vals)

    def _flush_buffer(self):
        """Dispatch the whole buffer inline.  The buffer clears only after a
        successful dispatch: a failed flush (out of memory, a launch error)
        leaves the microbatches intact for a retry.  Its stages are named
        ranges for ``torch.profiler`` (``plane.concat``, ``plane.h2d``,
        ``plane.dispatch``)."""
        keys, vals = self._concat_buffer()
        self._state = self._apply(self._state, keys, vals)
        self._clear_buffer()

    def drain(self):
        """Make every ingested element visible in ``state``: flush the host
        buffer and settle in-flight work."""
        if self._buf_keys:
            self._flush_buffer()
        self._settle()
        return self

    def _settle(self):
        """Wait for in-flight work (nothing on a synchronous plane)."""

    @property
    def state(self):
        """The settled device state (the host buffer is NOT flushed)."""
        self._settle()
        return self._state

    def set_state(self, st):
        """Replace the device state; in-flight work settles first, and a
        pending host buffer applies on top."""
        self._settle()
        self._state = st

    def close(self):
        """Release the plane's worker threads (nothing on a synchronous
        plane)."""


@register_plane("dense")
class DensePlane(DataPlane):
    """Plain reference plane: the spec's PyTorch update on the concatenated
    buffer, with no kernel."""

    def _dispatch(self, state, keys, values):
        # honour the padding contract (keys == -1 contribute nothing): the
        # plain update would hash key -1 into a real bucket, and a zero value
        # is a no-op on the linear sketch (every randomizer scales the value)
        values = torch.where(keys == -1, 0.0, values)
        return self.spec.update(state, keys, values)


@register_plane("sparse", "ingest")
class SparsePlane(DataPlane):
    """Scatter-kernel plane: one scatter launch per flush (``ingest_sparse``),
    dispatched inline at the flush boundary."""

    def _dispatch(self, state, keys, values):
        return ingest_sparse(self.spec, state, keys, values)


# Async planes whose worker thread runs: closed at interpreter exit (a
# daemon thread still inside a CUDA call during teardown can abort the
# process), and each one when it is collected.
_LIVE_ASYNC: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _shutdown_live_async_planes():
    for plane in list(_LIVE_ASYNC):
        try:
            plane.close()
        except Exception:
            pass


def _shutdown_worker(jobs: queue.Queue):
    """Finalizer of a collected AsyncPlane: ask its worker to exit (a full
    queue means the worker is alive and will see the request after the
    batch it holds; daemon threads never block interpreter exit)."""
    try:
        jobs.put_nowait(None)
    except queue.Full:
        pass


@register_plane("async")
class AsyncPlane(SparsePlane):
    """Double-buffered asynchronous scatter plane.

    Flush batches go to one worker thread, first in first out, which copies
    each to the card (``plane.h2d``), dispatches it (``plane.dispatch``) and
    waits for it before publishing the new state, so batch N runs while the
    producer accumulates batch N+1.  The job queue holds one batch beside
    the one the worker holds: a producer more than two batches ahead
    blocks, which bounds host memory.  The concatenation (``plane.concat``)
    stays on the producer.

    On the card, PyTorch's current device and stream belong to each thread:
    the worker enters ``torch.cuda.device(device)`` and dispatches on a
    ``torch.cuda.Stream`` of its own, after an event that the producer
    records on its current stream at submission (so the worker's kernels
    follow every read of the state the producer enqueued before).  It
    synchronizes that stream before it replaces the state, so a reader on
    another thread never sees a half-computed table, and a freed block of
    the old state is reused only by work ordered after those reads.

    Determinism: dispatch boundaries are decided on the producer side by
    the flush policy, never by the worker's timing, so the dispatch
    sequence equals ``SparsePlane``'s under the same policy and stream.
    Where every dispatch is deterministic (the CPU; the card under
    ``torch.use_deterministic_algorithms(True)``), the drained state and
    samples are bit for bit the synchronous plane's.

    Errors: a failed dispatch parks its batch and every batch queued behind
    it, in order; the next ``drain()`` or flush re-raises the error with
    those batches re-queued at the front of the host buffer, so a retry
    replays them in the original order.

    Interval: with ``FlushPolicy.max_interval`` set, a one-shot timer is
    armed whenever the host buffer becomes non-empty, so a producer that
    goes idle still has its tail submitted within the interval.  A timer
    flush submits to the same queue as any other, so the order holds; an
    error it meets is parked like a worker's."""

    _QUEUE_DEPTH = 1  # + the batch the worker holds = double buffering

    def __init__(self, spec, state, policy=None, codec: str = "none"):
        super().__init__(spec, state, policy=policy, codec=codec)
        self._jobs: queue.Queue = queue.Queue(maxsize=self._QUEUE_DEPTH)
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._parked: list = []     # batches skipped after an error, in order
        self._worker: Optional[threading.Thread] = None
        self._stream = None         # the worker's CUDA stream
        # the interval timer runs on its own thread, so every change of the
        # host buffer (ingest, flush, error requeue) holds this lock; an
        # RLock, since a flush that holds it re-enters through the requeue
        self._buf_lock = threading.RLock()
        self._timer: Optional[threading.Timer] = None
        # close()'s fence against a timer callback that had already started
        # (and waits on _buf_lock) when cancel() ran: it must neither restart
        # the worker nor queue a batch behind the exit request.  A later
        # ingest() reopens the plane.
        self._closed = False

    def _ensure_worker(self):
        if self._worker is None:
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._worker = threading.Thread(
                target=self._run, name="repro-torch-async-plane",
                daemon=True)
            self._worker.start()
            _LIVE_ASYNC.add(self)
            weakref.finalize(self, _shutdown_worker, self._jobs)

    def _on_device(self):
        """The worker's device and stream, entered for its whole life."""
        ctx = contextlib.ExitStack()
        if self._stream is not None:
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    def _run(self):
        with self._on_device():
            while True:
                job = self._jobs.get()
                if job is None:
                    self._jobs.task_done()
                    return
                keys, vals, ready = job
                try:
                    with self._lock:
                        if self._error is not None:
                            # keep the order behind the failed batch: park,
                            # so a retry replays failed + parked in sequence
                            self._parked.append((keys, vals))
                            continue
                    if ready is not None:
                        self._stream.wait_event(ready)
                    st = self._apply(self._state, keys, vals)
                    if self._stream is not None:
                        self._stream.synchronize()  # materialize, then publish
                    self._state = st
                except Exception as e:  # surfaced at the next drain/flush
                    with self._lock:
                        self._error = e
                        self._parked.append((keys, vals))
                finally:
                    self._jobs.task_done()

    # -- interval timer ------------------------------------------------------
    def ingest(self, keys, values):
        with self._buf_lock:
            self._closed = False  # an explicit ingest after close() reopens
            super().ingest(keys, values)
            if (self.policy.max_interval is not None and self._buf_keys
                    and self._timer is None):
                self._arm_timer(self.policy.max_interval)
        return self

    def drain(self):
        with self._buf_lock:
            self._cancel_timer()
            if self._buf_keys:
                self._flush_buffer()
        self._settle()
        return self

    def _arm_timer(self, delay: float):
        t = threading.Timer(max(delay, 0.0), self._timer_fire)
        t.daemon = True
        self._timer = t
        t.start()

    def _cancel_timer(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _timer_fire(self):
        with self._buf_lock:
            self._timer = None
            if self._closed:
                # lost the race with close(): the tail stays buffered for an
                # explicit drain or reuse
                return
            if not self._buf_keys or self.policy.max_interval is None:
                return
            age = time.monotonic() - self._buf_t0
            if age < self.policy.max_interval:
                # an ingest restarted the age clock: wait out the rest
                self._arm_timer(self.policy.max_interval - age)
                return
            try:
                # no pending-error check: a timer thread cannot raise to the
                # caller, so an earlier worker error stays parked until the
                # next drain/flush
                self._submit_buffer()
            except Exception as e:
                with self._lock:
                    if self._error is None:
                        self._error = e

    # -- flush / settle ------------------------------------------------------
    def _submit_buffer(self):
        self._ensure_worker()
        keys, vals = self._concat_buffer()
        self._clear_buffer()
        self._cancel_timer()
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._jobs.put((keys, vals, ready))

    def _flush_buffer(self):
        self._raise_pending_error()
        with self._buf_lock:
            if not self._buf_keys:
                return  # a timer flush took the buffer first
            self._submit_buffer()

    def _settle(self):
        if self._worker is not None:
            self._jobs.join()
        self._raise_pending_error()

    def _raise_pending_error(self):
        with self._lock:
            if self._error is None:
                return
        # settle the queue BEFORE clearing the error: batches still queued
        # behind the failure must park (the worker skips them while the
        # error is set), or they would run ahead of the re-queued batch
        self._jobs.join()
        with self._lock:
            err, self._error = self._error, None
            parked, self._parked = self._parked, []
        if err is None:
            return
        # re-queue the failed and parked batches ahead of anything buffered,
        # in their original order
        with self._buf_lock:
            for keys, vals in reversed(parked):
                self._buf_keys.insert(0, keys)
                self._buf_vals.insert(0, vals)
                self._buf_elems += keys.shape[1]
                self._buf_bytes += self._wire_bytes(keys, vals)
            if self._buf_t0 is None and self._buf_keys:
                self._buf_t0 = time.monotonic()
            pending = self._buf_elems
        raise RuntimeError(
            f"async ingest dispatch failed; the failed microbatches were "
            f"re-queued ({pending} per-stream elements pending) -- "
            f"drain() again to retry") from err

    def close(self):
        """Stop the worker thread; blocks until it finishes the batch it
        holds and exits.  A worker that does not stop within 60 s makes the
        plane refuse further use rather than risk two workers on one
        state."""
        with self._buf_lock:
            self._cancel_timer()
            self._closed = True  # fences a timer already past cancel()
        if self._worker is None:
            return
        self._jobs.put(None)
        self._worker.join(timeout=60.0)
        if self._worker.is_alive():
            raise RuntimeError(
                "async plane worker did not stop within 60 s (dispatch "
                "stuck?); the plane cannot be reused safely")
        self._worker = None


# ---------------------------------------------------------------------------
# per-shard + collapse plane
# ---------------------------------------------------------------------------

# The reference pads each shard's compacted block to its TPU lane width
# (128), so that flushes of similar sizes reuse one compiled trace.  The
# port compiles nothing per shape; it pads to one pass of the shared-memory
# scatter's block (``tiling.TABLE_THREADS`` slots: csrc/smem_table.cuh walks
# a stream that many slots at a time), so the longest row costs no extra
# pass, and flushes of similar sizes allocate blocks of the same size.
SHARD_PAD = tiling.TABLE_THREADS


def _compact_shard_rows(keys: np.ndarray, vals: np.ndarray,
                        mask: np.ndarray) -> tuple:
    """Per-row compaction of the masked slots of a (B, n) batch: selected
    entries slide left in order, rows pad with key -1 / value 0 to a
    multiple of ``SHARD_PAD`` columns.  Returns (keys', vals') of shape
    (B, m_pad)."""
    counts = mask.sum(axis=1)
    m = int(counts.max()) if counts.size else 0
    if m == 0:
        return (np.empty((keys.shape[0], 0), np.int32),
                np.empty((keys.shape[0], 0), np.float32))
    m = tiling.pad_to(m, SHARD_PAD)
    # a stable argsort of ~mask brings the selected slots to the front, in
    # order
    order = np.argsort(~mask, axis=1, kind="stable")
    take = order[:, :min(m, keys.shape[1])]
    gk = np.take_along_axis(keys, take, axis=1)
    gv = np.take_along_axis(vals, take, axis=1)
    if gk.shape[1] < m:
        gk = np.pad(gk, ((0, 0), (0, m - gk.shape[1])), constant_values=-1)
        gv = np.pad(gv, ((0, 0), (0, m - gv.shape[1])))
    live = np.arange(m)[None, :] < counts[:, None]
    return (np.where(live, gk, np.int32(-1)).astype(np.int32),
            np.where(live, gv, np.float32(0.0)).astype(np.float32))


def partition_by_key(keys: np.ndarray, vals: np.ndarray,
                     shards: int) -> list:
    """Hash-partition one (B, n) microbatch into ``shards`` compacted
    per-shard blocks ``[(keys_s, vals_s), ...]`` by
    ``hashing.shard_of_keys``; ``keys == -1`` padding belongs to no shard.
    A key's deletions land on the shard that saw its insertions.  The live
    entries of every block are the reference's bit for bit (the same keys,
    in the same order, in the same rows); only the padding differs."""
    shard_ids = hashing.shard_of_keys(keys, shards)
    live = keys != np.int32(-1)
    return [_compact_shard_rows(keys, vals, (shard_ids == s) & live)
            for s in range(shards)]


@register_plane("pipeline")
class PipelinePlane(DataPlane):
    """Per-shard + collapse plane.

    ``shards`` sub-planes (``subplane`` "sparse" or "async") start from the
    same state -- the same seeds, empty tables and candidates, so the
    copies are merge-neutral -- and each flushed batch is partitioned by key
    (``partition_by_key``) into disjoint sub-streams.  Every state read
    merges the shard states through the sampler's batched merge (the
    engine's ``_MERGES``, else the spec's).

    Contract: within the summing tolerances of a single plane, with the
    same samples (the merge refreshes candidates in another order); async
    sub-planes equal sparse sub-planes bit for bit where dispatch is
    deterministic.  With a lossy ``codec`` each shard state crosses the
    wire once (``Codec.roundtrip``) before the merge, so the collapse
    equals the merge of the roundtripped shard states; the sub-planes run
    in-process under codec ``none``.

    ``ingest_shard(s, keys, values)`` feeds sub-plane ``s`` a block already
    partitioned (safe from one producer thread per shard).  ``set_state``
    puts the state into shard 0 and resets the others to the initial
    state; it must be seed-compatible with it (the merge checks)."""

    def __init__(self, spec, state, policy=None, shards: int = 2,
                 subplane: str = "sparse", codec: str = "none"):
        super().__init__(spec, state, policy=policy, codec=codec)
        if shards < 1:
            raise ValueError(f"pipeline plane needs shards >= 1, got {shards}")
        if subplane == "pipeline":
            raise ValueError("pipeline sub-planes cannot nest")
        self.shards = int(shards)
        self.subplane = subplane
        self._initial = state    # the merge-neutral state set_state resets to
        self._merge = _MERGES.get(spec.name, spec.merge)
        # sub-planes flush every batch they get: this plane's policy (or the
        # caller of ingest_shard) sets the dispatch granularity
        self._subplanes = [make_plane(subplane, spec, state,
                                      policy=FlushPolicy(max_elems=1))
                           for _ in range(self.shards)]
        self._merged = None      # the collapse, until the next ingest

    def _flush_buffer(self):
        keys, vals = self._concat_buffer()
        for sub, (k, v) in zip(self._subplanes,
                               partition_by_key(keys, vals, self.shards)):
            if k.shape[1]:
                sub.ingest(k, v)
        self._clear_buffer()
        self._merged = None

    def ingest_shard(self, shard: int, keys, values):
        """Feed one block straight to sub-plane ``shard`` (every live key
        must hash to it), past this plane's buffer and policy."""
        self._merged = None
        self._subplanes[shard].ingest(keys, values)
        return self

    def _settle(self):
        for sub in self._subplanes:
            sub.drain()

    @property
    def state(self):
        """The shard states merged into one, settled."""
        self._settle()
        if self._merged is None:
            # each shard state crosses the wire ONCE (encoded + decoded)
            # before merging; codec "none" is a copy-free identity
            merged = self.codec.roundtrip(self._subplanes[0].state)
            for sub in self._subplanes[1:]:
                merged = self._merge(merged, self.codec.roundtrip(sub.state))
            self._merged = merged
        return self._merged

    def set_state(self, st):
        self._settle()
        self._subplanes[0].set_state(st)
        for sub in self._subplanes[1:]:
            sub.set_state(self._initial)
        self._merged = None

    def close(self):
        for sub in self._subplanes:
            sub.close()


# The in-process fleet registers itself as the "fleet" plane (replica-
# sharded ingest collapsed through the checkpoint merge protocol).
# Imported LAST, so the registry order -- and with it the conformance PATHS
# grid -- is (dense, sparse, async, pipeline, fleet) whichever module pulls
# the plane layer in first; fleet.py needs only names defined above.
from repro_torch.distributed import fleet as _fleet  # noqa: E402,F401
