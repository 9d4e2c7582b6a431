"""Data planes: how host-side turnstile microbatches reach sampler state.

Every plane shares one host-buffer discipline -- sparse signed
``(keys, values)`` microbatches accumulate as numpy arrays (no device work)
until a ``FlushPolicy`` fires -- and they differ only in the dispatch step:

  ``DensePlane``   the sampler spec's plain PyTorch update on the
                   concatenated batch (the reference plane).
  ``SparsePlane``  ``ingest_sparse``: one scatter-kernel launch for the
                   sketch delta, then the candidate refresh through one
                   estimate-kernel launch (the sampler-name registry below).

The asynchronous and pipeline planes, and wire codecs other than ``none``,
come with later slices of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import countsketch, transforms, worp
from repro_torch.core.sampler import SamplerSpec
from repro_torch.engine.engine import _leaves, _refresh_candidates
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# sparse kernel paths by sampler name: a sampler opts into the scatter-kernel
# plane with ``@register_sparse_path(name)`` (signature
# ``fn(state, keys, values, p, scheme)``).
# ---------------------------------------------------------------------------

_SPARSE_PATHS: dict = {}


def register_sparse_path(name: str):
    def deco(fn):
        _SPARSE_PATHS[name] = fn
        return fn

    return deco


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
    with record_function("sparse.scatter"):
        delta = ops.sketch_sparse_batch(
            keys, values, st.sketch.rows, st.sketch.width, st.sketch.seed,
            p=p, scheme=scheme, transform_seeds=st.seed_transform)
        sk = countsketch.CountSketch(table=st.sketch.table + delta,
                                     seed=st.sketch.seed)
    with record_function("sparse.refresh"):
        cand = _refresh_candidates(sk, st.cand_keys, keys)
    return worp.OnePassState(sketch=sk, cand_keys=cand,
                             seed_transform=st.seed_transform)


def ingest_sparse(spec: SamplerSpec, state, keys, values):
    """Route one batched sparse signed update through the sampler's kernel
    path."""
    path = _SPARSE_PATHS.get(spec.name)
    if path is None:
        raise NotImplementedError(
            f"sampler {spec.name!r} has no sparse kernel path (not ported "
            f"yet); registered: {sorted(_SPARSE_PATHS)}")
    return path(state, keys, values, spec.cfg.p, spec.cfg.scheme)


# ---------------------------------------------------------------------------
# flush policy
# ---------------------------------------------------------------------------

class FlushPolicy(NamedTuple):
    """When does the host buffer dispatch?  Any trigger that is not None
    fires the flush once reached.  Both depend only on the ingested data, so
    dispatch boundaries are reproducible.  (The wall-clock ``max_interval``
    trigger comes with the asynchronous plane.)"""

    max_elems: Optional[int] = 4096   # per-stream pending element count
    max_bytes: Optional[int] = None   # pending host-buffer bytes (keys+vals)

    def should_flush(self, elems: int, nbytes: int) -> bool:
        if self.max_elems is not None and elems >= self.max_elems:
            return True
        if self.max_bytes is not None and nbytes >= self.max_bytes:
            return True
        return False


# ---------------------------------------------------------------------------
# plane registry
# ---------------------------------------------------------------------------

_PLANES: dict = {}


def register_plane(name: str):
    """Register a DataPlane subclass under ``name``."""

    def deco(cls):
        cls.name = name
        _PLANES[name] = cls
        return cls

    return deco


def available_planes() -> tuple:
    """Registered plane names, in registration order."""
    return tuple(_PLANES)


def make_plane(name: str, spec: SamplerSpec, state,
               policy: Optional[FlushPolicy] = None,
               **plane_opts) -> "DataPlane":
    """Instantiate a registered plane over ``spec`` and its batched state
    (which lives on the device the plane dispatches to)."""
    cls = _PLANES.get(name)
    if cls is None:
        raise ValueError(f"unknown data plane {name!r}; registered planes: "
                         f"{sorted(set(_PLANES))}")
    return cls(spec, state, policy=policy, **plane_opts)


# ---------------------------------------------------------------------------
# the planes
# ---------------------------------------------------------------------------

class DataPlane:
    """Shared host-buffer discipline; subclasses define ``_dispatch``.

    The plane owns the batched sampler state while ingest is in progress;
    ``drain()`` flushes the host buffer and is what every read/merge
    boundary calls (``SketchEngine`` does)."""

    name = "abstract"

    def __init__(self, spec: SamplerSpec, state,
                 policy: Optional[FlushPolicy] = None, codec: str = "none"):
        if codec != "none":
            raise NotImplementedError(
                f"wire codec {codec!r} is not ported yet (only 'none')")
        self.spec = spec
        self.policy = policy if policy is not None else FlushPolicy()
        self.device = _leaves(state)[0].device
        self._state = state
        self._buf_keys: list = []
        self._buf_vals: list = []
        self._buf_elems = 0
        self._buf_bytes = 0

    def _dispatch(self, state, keys: torch.Tensor, values: torch.Tensor):
        raise NotImplementedError

    def ingest(self, keys, values):
        """Buffer one sparse signed (B, n) microbatch; dispatch when the
        flush policy fires.  Bytes count the raw int32 keys and float32
        values."""
        keys = np.asarray(keys, np.int32)
        values = np.asarray(values, np.float32)
        self._buf_keys.append(keys)
        self._buf_vals.append(values)
        self._buf_elems += keys.shape[1]
        self._buf_bytes += keys.nbytes + values.nbytes
        if self.policy.should_flush(self._buf_elems, self._buf_bytes):
            self._flush_buffer()
        return self

    @property
    def pending(self) -> int:
        """Per-stream element count buffered on the host."""
        return self._buf_elems

    @property
    def pending_bytes(self) -> int:
        return self._buf_bytes

    def _clear_buffer(self):
        self._buf_keys, self._buf_vals = [], []
        self._buf_elems = self._buf_bytes = 0

    def _flush_buffer(self):
        """Dispatch the whole buffer inline.  The buffer clears only after a
        successful dispatch: a failed flush (out of memory, a launch error)
        leaves the microbatches intact for a retry.  Its stages are named
        ranges for ``torch.profiler`` (``plane.concat``, ``plane.h2d``,
        ``plane.dispatch``)."""
        with record_function("plane.concat"):
            keys = np.concatenate(self._buf_keys, axis=1)
            vals = np.concatenate(self._buf_vals, axis=1)
        with record_function("plane.h2d"):
            keys = torch.from_numpy(keys).to(self.device)
            vals = torch.from_numpy(vals).to(self.device)
        with record_function("plane.dispatch"):
            self._state = self._dispatch(self._state, keys, vals)
        self._clear_buffer()

    def drain(self):
        """Make every ingested element visible in ``state``."""
        if self._buf_keys:
            self._flush_buffer()
        return self

    @property
    def state(self):
        """The device state (the host buffer is NOT flushed)."""
        return self._state

    def set_state(self, st):
        """Replace the device state; a pending host buffer applies on top."""
        self._state = st


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


@register_plane("sparse")
class SparsePlane(DataPlane):
    """Scatter-kernel plane: one scatter launch per flush (``ingest_sparse``),
    dispatched inline at the flush boundary."""

    def _dispatch(self, state, keys, values):
        return ingest_sparse(self.spec, state, keys, values)
