"""Batched multi-stream sampler engine (PyTorch port of ``repro.engine``).

A *batched state* is a sampler state whose every tensor has a leading
stream axis: for one-pass WORp, ``OnePassState.sketch.table`` is
(B, rows, width), ``seed_transform`` is (B,), and so on.  The core
functions and the registry's specs take that axis natively, so the engine
calls them directly.  ``SketchEngine(cfg, sampler="onepass"|"twopass"|
"perfect"|"tv")`` picks the sampler from the registry.

Seeding: independent streams hash their own sketch/transform seeds from the
engine seed (default); ``shared_seeds`` makes the B streams shards of one
logical stream, and ``reduce_streams`` collapses them in O(log B) merge
rounds.

Every read of a sketch goes through ``kernels.ops.estimate_batched``: one
launch of the estimate kernel, which reads each key's rows and takes their
median in registers, for all B streams on the card.  That covers the
candidate refresh, the one-pass sample, ``estimate``, the merges of the
sketch-backed samplers, the TV cascade's draws and the pass-II priorities
(``update_pass2``).  Dense segments (``update_dense``) go through one launch
of the dense update kernel; turnstile ingest is the data-plane layer in
``repro_torch.engine.planes``.  The perfect oracle holds no sketch and runs
its spec's plain PyTorch on the engine's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import countsketch, hashing, transforms, tv_sampler, worp
from repro_torch.core import sampler as core_sampler
from repro_torch.core.device import resolve_device
from repro_torch.core.perfect import Sample
from repro_torch.core.sampler import SamplerSpec
from repro_torch.kernels import ops


class EngineConfig(NamedTuple):
    num_streams: int          # B: streams batched as one state
    rows: int = 7
    width: int = 2048
    candidates: int = 512     # one-pass candidate buffer per stream
    capacity: int = 512       # two-pass exact-frequency buffer per stream
    p: float = 1.0
    scheme: str = transforms.PPSWOR
    seed: int = 0x5EED
    shared_seeds: bool = False  # True => streams are mergeable shards
    sampler: str = "onepass"    # registry key (see repro_torch.core.sampler)
    domain: int = 4096          # "perfect" sampler: frequency-vector size
    num_samplers: int = 8       # "tv" sampler: cascade length r


def sampler_config(cfg: EngineConfig) -> core_sampler.SamplerConfig:
    """Project the engine config onto the registry's SamplerConfig."""
    return core_sampler.SamplerConfig(
        rows=cfg.rows, width=cfg.width, candidates=cfg.candidates,
        capacity=cfg.capacity, p=cfg.p, scheme=cfg.scheme, domain=cfg.domain,
        num_samplers=cfg.num_samplers)


def engine_spec(cfg: EngineConfig) -> SamplerSpec:
    """The (cached) SamplerSpec this engine config selects."""
    return core_sampler.make_sampler(cfg.sampler, sampler_config(cfg))


def derive_stream_seeds(cfg: EngineConfig, offset: int = 0, device=None):
    """Per-stream (sketch, transform) seed vectors, both (B,) uint32 values
    in int64 tensors, bit for bit those of the reference, on ``device``
    (the card unless the caller asks otherwise).

    ``offset`` shifts the stream indices the seeds are hashed from (block t
    of a repeated-trial experiment passes ``t * num_streams``).  Ignored
    under ``shared_seeds``."""
    B = cfg.num_streams
    device = resolve_device(device)
    if cfg.shared_seeds:
        ones = torch.ones(B, dtype=torch.int64, device=device)
        return (ones * (cfg.seed & hashing.MASK32),
                ones * ((cfg.seed ^ 0xA5A5A5A5) & hashing.MASK32))
    b = (torch.arange(B, dtype=torch.int64, device=device)
         + offset) & hashing.MASK32
    return (hashing.hash_u32(b, cfg.seed),
            hashing.hash_u32(b, (cfg.seed & hashing.MASK32) ^ 0xA5A5A5A5))


def init_batched(cfg: EngineConfig, device=None):
    """Batched initial state of cfg's registered sampler on ``device`` (the
    card unless the caller asks otherwise)."""
    return engine_spec(cfg).init(*derive_stream_seeds(cfg, device=device))


def estimate_sketch(sk: countsketch.CountSketch, keys) -> torch.Tensor:
    """R.Est of a sketch of any batch shape ``(...)`` for (..., n) keys:
    the batch flattened into one estimate-kernel launch."""
    rows, width = sk.table.shape[-2:]
    n = keys.shape[-1]
    est = ops.estimate_batched(
        sk.table.reshape(-1, rows, width).contiguous(),
        keys.to(torch.int32).reshape(-1, n).contiguous(), sk.seed.reshape(-1))
    return est.reshape(keys.shape)


# ---------------------------------------------------------------------------
# batched one-pass WORp (the engine's kernel paths)
# ---------------------------------------------------------------------------

def onepass_init_batched(cfg: EngineConfig,
                         device=None) -> worp.OnePassState:
    sk_seeds, t_seeds = derive_stream_seeds(cfg, device=device)
    return worp.onepass_init(cfg.rows, cfg.width, cfg.candidates, sk_seeds,
                             t_seeds)


def _refresh_candidates(sk: countsketch.CountSketch, cand_keys, batch_keys):
    """Batched candidate refresh (the policy of ``worp.refresh_candidates``)
    with the estimates of (old candidates U batch keys) for all B streams
    from one estimate-kernel launch."""
    all_keys = torch.cat([cand_keys, batch_keys.to(cand_keys.dtype)], 1)
    est = torch.abs(ops.estimate_batched(sk.table, all_keys, sk.seed))
    return worp._refresh_from_estimates(all_keys, est, cand_keys.shape[1])


def onepass_update_dense(st: worp.OnePassState, values: torch.Tensor,
                         p: float, base_keys=None, lengths=None,
                         scheme: str = transforms.PPSWOR):
    """Dense fast path: B dense segments through one update-kernel launch.

    ``values[b, i]`` is the frequency increment of key ``base_keys[b] + i``
    (mod 2**32) for stream b; columns past ``lengths[b]`` are ignored.  The
    candidate refresh estimates the (C + n) per-stream keys through one
    estimate-kernel launch; the segment's keys enter it as int32 with
    two's-complement wrap, and -1 past ``lengths[b]``.  The kernel plans its blocks from the
    lengths on the host: lengths given as host values cost no wait for the
    card, a CUDA tensor one read-back."""
    B, n = values.shape
    dev = st.sketch.table.device
    base = hashing.as_u32(0 if base_keys is None else base_keys,
                          device=dev).expand(B)
    with record_function("dense.sketch"):
        delta = ops.sketch_dense_batch(
            values, st.sketch.rows, st.sketch.width, st.sketch.seed, p=p,
            scheme=scheme, transform_seeds=st.seed_transform,
            base_keys=base, lengths=lengths)
        sk = countsketch.CountSketch(table=st.sketch.table + delta,
                                     seed=st.sketch.seed)
    with record_function("dense.refresh"):
        lengths = torch.as_tensor(n if lengths is None else lengths,
                                  dtype=torch.int64, device=dev).expand(B)
        offs = torch.arange(n, dtype=torch.int64, device=dev)
        keys = torch.where(offs < lengths[:, None],
                           hashing.to_int32(base[:, None] + offs),
                           worp._EMPTY)
        cand = _refresh_candidates(sk, st.cand_keys, keys)
    return worp.OnePassState(sketch=sk, cand_keys=cand,
                             seed_transform=st.seed_transform)


def onepass_merge_batched(a: worp.OnePassState, b: worp.OnePassState):
    """Stream-wise merge of two batched states (same seeds stream by
    stream), with the candidate refresh on the query chokepoint."""
    worp.check_merge_seeds("onepass_merge",
                           seed_transform=(a.seed_transform, b.seed_transform))
    sk = countsketch.merge(a.sketch, b.sketch)
    return worp.OnePassState(
        sketch=sk, cand_keys=_refresh_candidates(sk, a.cand_keys, b.cand_keys),
        seed_transform=a.seed_transform)


def onepass_sample_batched(st: worp.OnePassState, k: int, p: float,
                           scheme: str = transforms.PPSWOR) -> Sample:
    """Per-stream WOR samples (every Sample field grows a leading (B,)
    axis); the candidate estimates come from one estimate-kernel launch."""
    est = ops.estimate_batched(st.sketch.table, st.cand_keys, st.sketch.seed)
    return worp.onepass_sample_from_estimates(st, est, k, p, scheme)


# ---------------------------------------------------------------------------
# batched two-pass WORp
# ---------------------------------------------------------------------------

def twopass_init_batched(cfg: EngineConfig,
                         device=None) -> worp.TwoPassState:
    _, t_seeds = derive_stream_seeds(cfg, device=device)
    return worp.twopass_init(cfg.capacity, t_seeds)


def twopass_update_batched(st: worp.TwoPassState,
                           frozen: countsketch.CountSketch, keys, values):
    """Pass-II step of B streams against the batched frozen pass-I sketch:
    the priorities of the (B, n) keys from one estimate-kernel launch."""
    keys = keys.to(torch.int32)
    prio = ops.estimate_batched(frozen.table, keys, frozen.seed)
    return worp.twopass_update_from_priorities(st, keys, values, prio)


# the core functions take the stream axis natively
twopass_merge_batched = worp.twopass_merge
twopass_sample_batched = worp.twopass_sample


def twopass_run_merge_batched(a, b):
    """Stream-wise merge of two batched ``TwoPassRunState``s; pass I's
    candidate refresh through the estimate kernel."""
    return core_sampler.TwoPassRunState(
        pass1=onepass_merge_batched(a.pass1, b.pass1),
        pass2=worp.twopass_merge(a.pass2, b.pass2))


# ---------------------------------------------------------------------------
# batched TV cascade
# ---------------------------------------------------------------------------

def tv_merge_batched(a: tv_sampler.TVSamplerState,
                     b: tv_sampler.TVSamplerState):
    """Stream-wise merge of two batched TV states: the B x r cascade
    sketches' candidate refresh is one estimate-kernel launch, the rHH's
    another."""
    sk = countsketch.merge(a.sketches, b.sketches)
    B, r, rows, width = sk.table.shape
    C = a.cand_keys.shape[-1]
    cand = _refresh_candidates(
        countsketch.CountSketch(table=sk.table.reshape(B * r, rows, width),
                                seed=sk.seed.reshape(B * r)),
        a.cand_keys.reshape(B * r, C), b.cand_keys.reshape(B * r, C))
    return tv_sampler.TVSamplerState(
        sketches=sk, cand_keys=cand.reshape(B, r, C),
        transform_seeds=a.transform_seeds,
        rhh=onepass_merge_batched(a.rhh, b.rhh))


def tv_sample_batched(st: tv_sampler.TVSamplerState, k: int, p: float,
                      scheme: str = transforms.PPSWOR) -> Sample:
    """Per-stream TV samples: each of the r cascade draws is one
    estimate-kernel launch for all B streams, and one more reads the rHH
    estimates of every candidate."""
    return tv_sampler.sample(st, k, p, scheme, estimate=estimate_sketch)


def reduce_streams(st, merge_batched):
    """Collapse a batched state's B streams to ONE state in ceil(log2 B)
    batched merge rounds (valid when the streams share seeds).  Each round
    merges the first half with the second half stream-wise; an odd stream
    carries to the next round."""
    num = _leaves(st)[0].shape[0]
    while num > 1:
        half = num // 2
        merged = merge_batched(_map(lambda x: x[:half], st),
                               _map(lambda x: x[half:2 * half], st))
        if num % 2:
            merged = _map2(lambda m, c: torch.cat([m, c], 0), merged,
                           _map(lambda x: x[2 * half:], st))
        st, num = merged, half + (num % 2)
    return _map(lambda x: x[0], st)


def _leaves(st) -> list:
    if isinstance(st, torch.Tensor):
        return [st]
    return [leaf for field in st for leaf in _leaves(field)]


def _map(fn, st):
    if isinstance(st, torch.Tensor):
        return fn(st)
    return type(st)(*(_map(fn, field) for field in st))


def _map2(fn, a, b):
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return type(a)(*(_map2(fn, x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# the engine's kernel routes by sampler name: a sketch-backed sampler reads
# its sketches through the estimate kernel; a sampler without an entry runs
# its spec (the two-pass sample reads no sketch, the perfect oracle none)
# ---------------------------------------------------------------------------

_MERGES = {"onepass": onepass_merge_batched,
           "twopass": twopass_run_merge_batched,
           "tv": tv_merge_batched}
_SAMPLES = {"onepass": onepass_sample_batched, "tv": tv_sample_batched}
_ESTIMATE_SKETCHES = {"onepass": lambda st: st.sketch,
                      "twopass": lambda st: st.pass1.sketch,
                      "tv": lambda st: st.rhh.sketch}


# ---------------------------------------------------------------------------
# stateful engine
# ---------------------------------------------------------------------------

class SketchEngine:
    """Holds the batched state of B sampler streams on one device, plus an
    exact pass-II state once ``freeze`` starts one.

    ``device=None`` means the card; with no card the engine raises unless
    the caller passes ``device="cpu"``, which runs the plain PyTorch
    versions of the kernels.

    Data plane: ``plane=`` picks how turnstile microbatches reach the state
    (``repro_torch.engine.planes``).  ``ingest(keys, values)`` buffers
    sparse signed microbatches on the host, and the plane's ``FlushPolicy``
    decides when they go to the device: the default ``"sparse"`` plane makes
    one scatter-kernel launch per flush, ``"async"`` makes it on a worker
    thread while the producer fills the next batch, ``"pipeline"``
    partitions each batch by key across shard planes merged at every read,
    and ``"dense"`` is the plain reference plane.  ``plane_opts`` are the
    plane's own keywords (``{"shards": 4, "subplane": "async"}`` for the
    pipeline).  Every read or state-mixing operation drains the plane
    first.
    """

    def __init__(self, cfg: EngineConfig, sampler: Optional[str] = None,
                 flush_elems: int = 4096, plane: str = "sparse",
                 flush=None, device=None, plane_opts: Optional[dict] = None):
        from repro_torch.engine import planes

        if sampler is not None and sampler != cfg.sampler:
            cfg = cfg._replace(sampler=sampler)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.spec = engine_spec(cfg)
        policy = flush if flush is not None \
            else planes.FlushPolicy(max_elems=int(flush_elems))
        self._plane = planes.make_plane(
            plane, self.spec,
            self.spec.init(*derive_stream_seeds(cfg, device=self.device)),
            policy=policy, **(plane_opts or {}))
        self._merge = _MERGES.get(cfg.sampler, self.spec.merge)
        self.pass2 = None

    @property
    def num_streams(self) -> int:
        return self.cfg.num_streams

    @property
    def sampler(self) -> str:
        return self.cfg.sampler

    @property
    def plane(self):
        """The engine's DataPlane instance."""
        return self._plane

    @property
    def state(self):
        """The batched sampler state (microbatches still in the host buffer
        stay pending; ``flush()`` applies them)."""
        return self._plane.state

    @state.setter
    def state(self, st):
        self._plane.set_state(st)

    def update(self, keys, values):
        """Sparse element batches (B, n), applied at once through the
        sparse kernel path.  Any pending ingest buffer drains FIRST, so the
        elements apply in call order (the streaming two-pass state depends
        on it)."""
        from repro_torch.engine import planes

        self.flush()
        self.state = planes.ingest_sparse(
            self.spec, self.state, self._to_device(keys, torch.int32),
            self._to_device(values, torch.float32))
        return self

    def _to_device(self, x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype).contiguous()
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def ingest(self, keys, values):
        """Buffer a sparse signed (B, n) turnstile microbatch on the host.

        Negative values are deletions; ``keys == -1`` slots are padding.
        Microbatches dispatch when the FlushPolicy fires (or on the next
        read/flush)."""
        keys = np.asarray(keys, np.int32)
        values = np.asarray(values, np.float32)
        if keys.shape != values.shape or keys.ndim != 2 \
                or keys.shape[0] != self.cfg.num_streams:
            raise ValueError(
                f"ingest: keys/values must both be (num_streams="
                f"{self.cfg.num_streams}, n), got {keys.shape} / "
                f"{values.shape}")
        self._plane.ingest(keys, values)
        return self

    @property
    def pending(self) -> int:
        """Per-stream element count buffered, not yet flushed."""
        return self._plane.pending

    def flush(self):
        """Drain the data plane: dispatch buffered microbatches."""
        self._plane.drain()
        return self

    def update_dense(self, values, base_keys=None, lengths=None):
        """Dense segments (B, n) through one update-kernel launch, after any
        pending ingest buffer: stream b's ``values[b, i]`` is the increment
        of key ``base_keys[b] + i`` for ``i < lengths[b]``.

        One-pass WORp only: the other samplers have no dense kernel path."""
        if self.cfg.sampler != "onepass":
            raise ValueError(
                f"update_dense: sampler {self.cfg.sampler!r} has no dense "
                f"kernel path (only 'onepass'); use update()")
        self.flush()
        self.state = onepass_update_dense(
            self.state, self._to_device(values, torch.float32), self.cfg.p,
            base_keys=base_keys, lengths=lengths, scheme=self.cfg.scheme)
        return self

    def merge_with(self, other: "SketchEngine"):
        """Stream-wise union with another engine of an identical config."""
        ocfg = getattr(other, "cfg", None)
        if not isinstance(other, SketchEngine) or ocfg is None:
            raise TypeError(
                f"merge_with expects a SketchEngine, got {type(other).__name__}")
        self.flush()
        other.flush()
        if ocfg != self.cfg:
            diff = [f"{f}={getattr(self.cfg, f)!r} vs {getattr(ocfg, f)!r}"
                    for f in self.cfg._fields
                    if getattr(self.cfg, f) != getattr(ocfg, f)]
            raise ValueError(
                "merge_with: engines are not mergeable -- stream-wise union "
                "requires identical EngineConfig (per-stream hash seeds and "
                "state shapes must agree, or the merged sketch is garbage); "
                "mismatched fields: " + ", ".join(diff))
        self.state = self._merge(self.state, other.state)
        return self

    def sample(self, k: int) -> Sample:
        self.flush()
        return self.sample_state(self.state, k)

    def sample_state(self, state, k: int) -> Sample:
        """Per-stream WOR samples of an arbitrary batched state of this
        engine's sampler, without touching the engine's own state."""
        route = _SAMPLES.get(self.cfg.sampler)
        if route is None:
            return self.spec.sample(state, k)
        return route(state, k, self.cfg.p, self.cfg.scheme)

    def estimate(self, keys) -> torch.Tensor:
        """Per-stream transformed-domain estimates for (B, n) keys."""
        self.flush()
        keys = self._to_device(keys, torch.int32)
        sketch_of = _ESTIMATE_SKETCHES.get(self.cfg.sampler)
        if sketch_of is None:
            return self.spec.estimate(self.state, keys)
        sk = sketch_of(self.state)
        return ops.estimate_batched(sk.table, keys, sk.seed)

    # -- exact pass II (samplers with a frozen-priority second pass) --------
    def freeze(self):
        """Freeze the pass-I priorities and start the exact second pass."""
        if not self.spec.two_phase:
            raise ValueError(
                f"freeze: sampler {self.cfg.sampler!r} has no exact second "
                f"pass (two-phase samplers: onepass, twopass)")
        self.flush()
        self.pass2 = self.spec.init2(self.state)
        return self

    def _frozen_sketch(self):
        """The batched frozen pass-I CountSketch behind the pass-II
        priorities (None for a sampler that registered no accessor with
        ``planes.register_frozen_sketch``)."""
        from repro_torch.engine import planes

        getter = planes.frozen_sketch_getter(self.cfg.sampler)
        return getter(self.state) if getter is not None else None

    def _require_pass2(self):
        if self.pass2 is None:
            raise RuntimeError("call freeze() before pass II")

    def update_pass2(self, keys, values):
        """Exact-frequency pass-II replay of (B, n) batches; the priorities
        against the FROZEN pass-I sketch come from one estimate-kernel
        launch for all B streams (``twopass_update_batched``)."""
        self._require_pass2()
        keys = self._to_device(keys, torch.int32)
        values = self._to_device(values, torch.float32)
        frozen = self._frozen_sketch()
        if frozen is None:
            self.pass2 = self.spec.update2(self.pass2, self.state, keys,
                                           values)
        else:
            self.pass2 = twopass_update_batched(self.pass2, frozen, keys,
                                                values)
        return self

    def sample_exact(self, k: int) -> Sample:
        """The exact two-pass sample of the pass-II state."""
        self._require_pass2()
        return self.spec.sample2(self.pass2, k)

    # -- shard collapse -----------------------------------------------------
    def collapse(self):
        """Merge all B streams into one state (requires shared_seeds)."""
        if not self.cfg.shared_seeds:
            raise ValueError("collapse() requires shared_seeds=True "
                             "(independent streams are not mergeable)")
        self.flush()
        return reduce_streams(self.state, self._merge)
