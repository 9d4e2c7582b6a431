"""Sharded, prefetching ingestion pipeline: producers -> packer -> plane.

The port's counterpart of ``repro.data.ingest_pipeline``, feeding the
port's ``SketchEngine`` and data planes.  The only difference is the block
span: the port sizes it by its own kernels' tiling
(``repro_torch.kernels.tiling.packed_span``, a whole number of
``PACK_QUANTUM`` = 1024 slots: two passes of the shared-memory scatter's
512-slot block and one stage of the deterministic scatter), where the
reference follows its Pallas n-blocks.  So spans differ from the
reference's; the event multiset and its order do not.

The paper's sketches are composable precisely so that many independent
producers can feed shards that merge losslessly (Sec. 1); this module is
the producer side of that story -- the layer that turns ANY iterable of
signed ``(key, +-value)`` turnstile events into kernel-ready fixed-shape
microbatches and feeds a ``SketchEngine`` (or any data plane) at full
rate.  Three pieces, composable on their own:

``ShardedSource``
    splits one canonical event stream across S producer shards by PER-KEY
    hash (``hashing.shard_of_keys``): the shard slices are disjoint, their
    union is the same event multiset for every S, and a key's deletions
    always land on the shard that saw its insertions -- the property that
    makes per-shard sub-sketches merge to the full-stream sketch.

``PackedBatcher``
    coalesces ragged event batches into FIXED-SHAPE ``(streams, span)``
    blocks sized to the scatter kernel's tiling (``tiling.packed_span``).
    Live streams emit arbitrary-length batches; packing amortizes the
    host-to-device copy and the launch over whole blocks, and keeps every
    flush a whole number of the kernel's passes; only the final tail block
    carries padding (key -1 / value 0), measured as ``pack_efficiency``.

``PrefetchingFeeder``
    S producer threads run source shard -> batcher -> a bounded ring
    buffer each (prefetch depth = backpressure: a producer that runs ahead
    BLOCKS, never drops).  Two consumption modes:

    * fan-in (default): the caller's ``pump()``/``run()`` moves blocks
      into ONE sink plane in a deterministic shard round-robin order --
      producer timing moves only where threads wait, never the dispatch
      sequence, so a fan-in feed into the async plane stays BIT-IDENTICAL
      to the synchronous plane under the same flush policy.
    * per-shard (``pershard=True``): each producer feeds its own sub-plane
      of a ``PipelinePlane`` directly (``ingest_shard``); dispatches run
      concurrently across shards and every state read collapses the shard
      states through the sampler's merge.  Equivalence to the single-plane
      path is KS-level (merge-tree fp/candidate order), which is exactly
      what the conformance grid's ``pipeline`` path pins.

    On the card, fan-in into the async plane equals the sparse plane bit
    for bit under ``torch.use_deterministic_algorithms(True)`` (the
    scatter's float atomics sum in a varying order otherwise); on the CPU
    always.

Error contract: a producer that raises mid-stream records its error, posts
its end-of-stream marker (so nothing deadlocks), and exits; the error
re-raises at ``run()``/``finish()`` -- the drain boundary -- wrapped with
the shard id.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import hashing
from repro_torch.kernels import tiling

from .pipeline import TurnstileZipfStream

_DONE = object()

Event = Tuple[np.ndarray, np.ndarray]


class ShardedSource:
    """Deterministic per-key split of one canonical event stream.

    ``events`` is either a zero-arg callable returning a FRESH iterator of
    ``(keys, values)`` batches, or a re-iterable of them (each shard walks
    its own iteration).  Shard ``s`` sees exactly the events whose key
    hashes to ``s`` -- shard-count-independent, order-preserving within the
    canonical sequence.
    """

    def __init__(self, events, num_shards: int = 1):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self._events = events
        self.num_shards = int(num_shards)

    @classmethod
    def from_turnstile(cls, stream: TurnstileZipfStream, n: int,
                       num_shards: int = 1, start_step: int = 0,
                       nsteps: Optional[int] = None) -> "ShardedSource":
        """Shard a ``TurnstileZipfStream``'s canonical sequence (one
        microbatch of ``n`` inserts + retractions per step)."""
        return cls(lambda: stream.event_iterator(n, start_step, nsteps),
                   num_shards=num_shards)

    def _fresh(self) -> Iterator[Event]:
        src = self._events() if callable(self._events) else self._events
        return iter(src)

    def shard_events(self, shard: int) -> Iterator[Event]:
        """Shard ``shard``'s flat (1-D keys, values) event sub-stream."""
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.num_shards})")
        for keys, vals in self._fresh():
            keys = np.asarray(keys, np.int32).reshape(-1)
            vals = np.asarray(vals, np.float32).reshape(-1)
            if self.num_shards > 1:
                sel = hashing.shard_of_keys(keys, self.num_shards) == shard
                keys, vals = keys[sel], vals[sel]
            yield keys, vals


class PackedBatcher:
    """Coalesce ragged events into fixed-shape kernel-ready blocks.

    Every emitted block is ``(streams, span)`` int32/float32 with ``span``
    quantized by ``tiling.packed_span`` to a whole number of
    ``tiling.PACK_QUANTUM`` slots, so the flush concatenation shapes
    downstream are multiples of one quantum.  Events
    broadcast across the ``streams`` rows (the engine's B independent
    sampler streams all observe the same data, each under its own seeds).
    Only ``flush_tail`` pads (key -1 / value 0 -- the library-wide padding
    contract); full blocks are pack-perfect.
    """

    def __init__(self, block_elems: int, streams: int = 1):
        if block_elems < 1:
            raise ValueError(f"block_elems must be >= 1, got {block_elems}")
        self.span = int(tiling.packed_span(int(block_elems)))
        self.streams = int(streams)
        self._k: list = []
        self._v: list = []
        self._n = 0
        self.events = 0       # live events packed so far
        self.blocks = 0       # blocks emitted so far
        self.pad_slots = 0    # padding slots emitted (tail blocks only)

    def _block(self, k: np.ndarray, v: np.ndarray) -> Event:
        self.blocks += 1
        return (np.broadcast_to(k[None, :], (self.streams, self.span)),
                np.broadcast_to(v[None, :], (self.streams, self.span)))

    def add(self, keys, values) -> list:
        """Append one ragged event batch; returns the (possibly empty)
        list of full blocks it completed."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        values = np.asarray(values, np.float32).reshape(-1)
        if keys.shape != values.shape:
            raise ValueError(f"keys/values shape mismatch: "
                             f"{keys.shape} vs {values.shape}")
        if keys.size:
            self._k.append(keys)
            self._v.append(values)
            self._n += keys.size
            self.events += keys.size
        if self._n < self.span:
            return []
        k = np.concatenate(self._k)
        v = np.concatenate(self._v)
        out = []
        pos = 0
        while k.size - pos >= self.span:
            out.append(self._block(k[pos:pos + self.span],
                                   v[pos:pos + self.span]))
            pos += self.span
        self._k = [k[pos:]] if pos < k.size else []
        self._v = [v[pos:]] if pos < k.size else []
        self._n = k.size - pos
        return out

    def flush_tail(self) -> Optional[Event]:
        """The final partial block, padded to shape (or None if empty)."""
        if self._n == 0:
            return None
        k = np.concatenate(self._k)
        v = np.concatenate(self._v)
        kk = np.full(self.span, -1, np.int32)
        vv = np.zeros(self.span, np.float32)
        kk[:k.size] = k
        vv[:v.size] = v
        self.pad_slots += self.span - k.size
        self._k, self._v, self._n = [], [], 0
        return self._block(kk, vv)

    @property
    def pack_efficiency(self) -> float:
        """Live events / emitted capacity (1.0 = zero padding)."""
        cap = self.blocks * self.span
        return 1.0 if cap == 0 else self.events / cap


class FeederStats(NamedTuple):
    """End-of-run accounting from ``PrefetchingFeeder.run()``."""
    shards: int
    events: int            # live events delivered (all shards)
    blocks: int            # fixed-shape blocks dispatched
    span: int              # per-stream block capacity
    pack_efficiency: float
    producer_wait_s: float  # total time producers blocked on backpressure
    pump_wait_s: float      # time the consumer waited on producers
    elapsed_s: float

    @property
    def events_per_s(self) -> float:
        return self.events / self.elapsed_s if self.elapsed_s > 0 else 0.0


class PrefetchingFeeder:
    """S producer threads -> bounded rings -> one sink, with backpressure.

    ``sink`` is a ``SketchEngine`` or any ``DataPlane`` (anything with
    ``ingest(keys, values)`` plus ``flush()``/``drain()``).  ``streams``
    defaults to the sink engine's stream count (1 otherwise).

    ``prefetch`` bounds how many PACKED blocks a producer may run ahead of
    the consumer (its ring-buffer capacity); ``prefetch=0`` degenerates to
    a single rendezvous hand-off slot (a producer is never more than one
    block ahead).  Producers always BLOCK on a full ring -- the pipeline
    never drops or reorders events.

    Fan-in mode (default): the caller drives ``pump()`` (or just ``run()``)
    and blocks move into the sink in shard round-robin order -- shard 0's
    next block, then shard 1's, ... -- which is deterministic regardless of
    producer timing.  Between ``pump`` calls the caller may freely
    interleave its own ``update``/``ingest`` on the sink (single consumer
    thread: the plane only ever sees one mutator).

    Per-shard mode (``pershard=True``): the sink must be (or wrap, as
    ``SketchEngine.plane``) a ``PipelinePlane`` with ``shards`` equal to
    the source's; each producer feeds its own sub-plane directly and
    dispatches overlap across shards.  ``run()`` joins the producers and
    drains (collapses) the plane.
    """

    def __init__(self, source: ShardedSource, sink, block_elems: int = 4096,
                 streams: Optional[int] = None, prefetch: int = 2,
                 pershard: bool = False):
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.source = source
        self.sink = sink
        self.pershard = bool(pershard)
        cfg = getattr(sink, "cfg", None)
        self.streams = int(streams if streams is not None
                           else getattr(cfg, "num_streams", 1))
        self.block_elems = int(block_elems)
        self._prefetch = max(1, int(prefetch))  # 0 -> one hand-off slot
        self._plane = self._resolve_pershard_plane() if self.pershard else None
        self._batchers = [PackedBatcher(self.block_elems, self.streams)
                          for _ in range(source.num_shards)]
        self._rings = [queue.Queue(maxsize=self._prefetch)
                       for _ in range(source.num_shards)]
        self._threads: list = []
        self._errors: list = [None] * source.num_shards
        self._producer_wait = [0.0] * source.num_shards
        self._pump_wait = 0.0
        self._done = [False] * source.num_shards
        self._rr = 0        # round-robin cursor, persistent across pump()s
        self._stop = False
        self._t0: Optional[float] = None
        self._elapsed: Optional[float] = None

    # -- setup ---------------------------------------------------------------
    def _resolve_pershard_plane(self):
        from repro_torch.engine import planes

        plane = self.sink if isinstance(self.sink, planes.PipelinePlane) \
            else getattr(self.sink, "plane", None)
        if not isinstance(plane, planes.PipelinePlane):
            raise ValueError(
                "pershard=True needs a PipelinePlane sink (or an engine on "
                f"plane='pipeline'); got {type(self.sink).__name__}")
        if plane.shards != self.source.num_shards:
            raise ValueError(
                f"pershard shard-count mismatch: source has "
                f"{self.source.num_shards}, plane has {plane.shards}")
        return plane

    # -- producers -----------------------------------------------------------
    def _put(self, shard: int, item) -> bool:
        """Blocking ring put with backpressure accounting; returns False if
        the feeder was closed while waiting."""
        ring = self._rings[shard]
        t0 = time.perf_counter()
        while not self._stop:
            try:
                ring.put(item, timeout=0.1)
                self._producer_wait[shard] += time.perf_counter() - t0
                return True
            except queue.Full:
                continue
        return False

    def _producer(self, shard: int):
        batcher = self._batchers[shard]
        try:
            emit = ((lambda blk: self._plane.ingest_shard(shard, *blk))
                    if self.pershard else
                    (lambda blk: self._put(shard, blk)))
            for keys, vals in self.source.shard_events(shard):
                if self._stop:
                    break
                for blk in batcher.add(keys, vals):
                    emit(blk)
            tail = batcher.flush_tail()
            if tail is not None and not self._stop:
                emit(tail)
        except BaseException as e:  # surfaces at finish()/run()
            self._errors[shard] = e
        finally:
            if not self.pershard:
                self._put(shard, _DONE)

    def start(self) -> "PrefetchingFeeder":
        if self._threads:
            raise RuntimeError("feeder already started")
        self._t0 = time.perf_counter()
        for s in range(self.source.num_shards):
            t = threading.Thread(target=self._producer, args=(s,),
                                 name=f"repro-torch-ingest-producer-{s}",
                                 daemon=True)
            self._threads.append(t)
            t.start()
        return self

    # -- consumer ------------------------------------------------------------
    def pump(self, max_blocks: Optional[int] = None) -> int:
        """Fan-in only: move up to ``max_blocks`` blocks (all remaining if
        None) into the sink in deterministic shard round-robin order;
        returns the number moved.  Blocks on the next shard in the cycle
        until its producer supplies a block or finishes."""
        if self.pershard:
            return 0
        moved = 0
        # persistent cursor: a chunked sequence of pump() calls consumes in
        # EXACTLY the same order as one pump() -- the determinism contract
        while not all(self._done):
            if max_blocks is not None and moved >= max_blocks:
                break
            s = self._rr
            self._rr = (self._rr + 1) % self.source.num_shards
            if self._done[s]:
                continue
            t0 = time.perf_counter()
            item = self._rings[s].get()
            self._pump_wait += time.perf_counter() - t0
            if item is _DONE:
                self._done[s] = True
                continue
            self.sink.ingest(*item)
            moved += 1
        return moved

    # -- teardown ------------------------------------------------------------
    def _drain_sink(self):
        drain = getattr(self.sink, "drain", None) \
            or getattr(self.sink, "flush", None)
        if drain is not None:
            drain()

    def finish(self) -> FeederStats:
        """Join producers, surface any producer error, drain the sink, and
        return the run's accounting."""
        for t in self._threads:
            t.join()
        self._elapsed = time.perf_counter() - self._t0 \
            if self._t0 is not None else 0.0
        errs = [(s, e) for s, e in enumerate(self._errors) if e is not None]
        if errs:
            shard, err = errs[0]
            raise RuntimeError(
                f"ingest producer shard {shard} failed "
                f"({len(errs)}/{self.source.num_shards} producers errored); "
                f"already-dispatched blocks remain applied") from err
        self._drain_sink()
        return self.stats()

    def run(self) -> FeederStats:
        """start -> consume everything -> finish; the one-call pipeline."""
        self.start()
        if not self.pershard:
            self.pump()
        return self.finish()

    def stats(self) -> FeederStats:
        events = sum(b.events for b in self._batchers)
        blocks = sum(b.blocks for b in self._batchers)
        span = self._batchers[0].span if self._batchers else 0
        cap = blocks * span
        elapsed = self._elapsed if self._elapsed is not None else (
            time.perf_counter() - self._t0 if self._t0 is not None else 0.0)
        return FeederStats(
            shards=self.source.num_shards, events=events, blocks=blocks,
            span=span,
            pack_efficiency=(1.0 if cap == 0 else events / cap),
            producer_wait_s=sum(self._producer_wait),
            pump_wait_s=self._pump_wait, elapsed_s=elapsed)

    def close(self):
        """Abandon the run: unblock and join the producers without draining
        (already-dispatched work stays applied; buffered blocks drop)."""
        self._stop = True
        for t in self._threads:
            while t.is_alive():
                for ring in self._rings:
                    try:
                        ring.get_nowait()
                    except queue.Empty:
                        pass
                t.join(timeout=0.05)
