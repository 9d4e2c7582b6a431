"""Deterministic signed turnstile stream (numpy only).

``TurnstileZipfStream`` produces sparse SIGNED ``(key, +-value)`` batches --
insertions plus deterministic retractions of earlier insertions -- that
feed ``SketchEngine.ingest``.  ``sparse_batch_at(step, shard, n)`` is a pure
function of its arguments, so a restarted job replays exactly the batches a
crashed one would have seen, and both packages see the same stream.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np

from repro_torch.core import hashing


class TurnstileZipfStream(NamedTuple):
    """Signed sparse Zipf update stream (the paper's turnstile model).

    Batch ``t`` emits ``n`` fresh Zipf[alpha] insertions (+1) followed by
    RETRACTIONS (-1) of the first ``floor(n * delete_fraction)`` insertions
    of batch ``t-1``.  Every deletion cancels a prior insertion, so the
    aggregated frequency vector stays nonnegative.
    """
    vocab_size: int
    alpha: float
    seed: int
    delete_fraction: float = 0.25

    def _inserts(self, step: int, shard: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        ranks = rng.zipf(self.alpha, size=n)
        return np.minimum(ranks - 1, self.vocab_size - 1).astype(np.int32)

    def sparse_batch_at(self, step: int, shard: int, n: int
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(keys, values): n inserts, then batch t-1's leading retractions."""
        ins = self._inserts(step, shard, n)
        keys = [ins]
        vals = [np.ones(n, np.float32)]
        ndel = int(n * self.delete_fraction)
        if step > 0 and ndel:
            keys.append(self._inserts(step - 1, shard, n)[:ndel])
            vals.append(-np.ones(ndel, np.float32))
        return np.concatenate(keys), np.concatenate(vals)

    def aggregate_freqs(self, shard: int, nsteps: int, n: int) -> np.ndarray:
        """Exact aggregated frequency vector of steps [0, nsteps)."""
        f = np.zeros(self.vocab_size, np.float64)
        for t in range(nsteps):
            k, v = self.sparse_batch_at(t, shard, n)
            np.add.at(f, k, v)
        return f

    def events_at(self, step: int, n: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        """The canonical (shard-count-independent) signed events of step t."""
        return self.sparse_batch_at(step, 0, n)

    def shard_batch_at(self, step: int, shard: int, num_shards: int, n: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Shard ``shard``'s slice of the canonical step-t events under
        per-key hash partitioning: the S slices are disjoint and union back
        to ``events_at`` for any S."""
        keys, vals = self.events_at(step, n)
        sel = hashing.shard_of_keys(keys, num_shards) == shard
        return keys[sel], vals[sel]

    def event_iterator(self, n: int, start_step: int = 0,
                       nsteps: Optional[int] = None
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Canonical signed-event microbatch iterator (one step each)."""
        step = start_step
        while nsteps is None or step < start_step + nsteps:
            yield self.events_at(step, n)
            step += 1
