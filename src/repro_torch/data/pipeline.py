"""Deterministic synthetic streams and a WORp frequency sketcher.

Determinism contract: ``ZipfStream.batch_at(step, shard, ...)`` and
``TurnstileZipfStream.sparse_batch_at(step, shard, n)`` are pure functions
of their arguments (numpy, bit for bit the reference's), so a restarted job
replays exactly the batches a crashed one would have seen, and both
packages see the same stream.

``TurnstileZipfStream`` produces sparse SIGNED ``(key, +-value)`` batches --
insertions plus deterministic retractions of earlier insertions -- that
feed ``SketchEngine.ingest`` and ``FrequencySketcher.observe_signed``.

``FrequencySketcher`` summarizes token/example frequencies with a
composable one-pass WORp sketch (one per shard, merged across shards), and
``selection_weights`` turns its WOR sample into p-th-power frequency
weights for example re-weighting (paper Sec. 1).
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import countsketch, hashing, worp
from repro_torch.core.device import resolve_device


class ZipfStream(NamedTuple):
    """Synthetic Zipf[alpha] token stream (the paper's experimental family)."""
    vocab_size: int
    alpha: float
    seed: int

    def batch_at(self, step: int, shard: int, batch: int, seq: int
                 ) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        ranks = rng.zipf(self.alpha, size=(batch, seq))
        return np.minimum(ranks - 1, self.vocab_size - 1).astype(np.int32)

    def lm_batch(self, step: int, shard: int, batch: int, seq: int,
                 device=None) -> dict:
        """Next-token batch: ``tokens`` and ``labels`` (batch, seq) int32
        tensors on ``device`` (the card unless the caller asks otherwise)."""
        device = resolve_device(device)
        toks = torch.from_numpy(self.batch_at(step, shard, batch, seq + 1))
        return {"tokens": toks[:, :-1].to(device),
                "labels": toks[:, 1:].to(device)}

    def iterator(self, shard: int, batch: int, seq: int,
                 start_step: int = 0, device=None) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.lm_batch(step, shard, batch, seq, device=device)
            step += 1


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


class FrequencySketcher:
    """Composable WORp sketch over a token stream (per shard; mergeable),
    on ``device`` (the card unless the caller asks otherwise)."""

    def __init__(self, k: int = 128, rows: int = 7, width: int = 0,
                 p: float = 0.5, seed: int = 17, device=None):
        width = width or 31 * k  # the paper's practical k x 31 size
        self.k, self.p = k, p
        self.state = worp.onepass_init(rows, width, 4 * k, seed, seed + 1,
                                       device=device)
        self.device = self.state.sketch.table.device

    def _tensor(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype).reshape(-1)
        return torch.tensor(np.asarray(x), dtype=dtype,
                            device=self.device).reshape(-1)

    def observe(self, tokens):
        flat = self._tensor(tokens, torch.int32)
        self.state = worp.onepass_update(
            self.state, flat, torch.ones_like(flat, dtype=torch.float32),
            self.p)

    def observe_signed(self, keys, values, use_kernel: bool = False):
        """Turnstile ingest of a sparse signed (key, +-value) batch, e.g.
        from ``TurnstileZipfStream.sparse_batch_at``: linearity means a
        ``-v`` update exactly cancels a prior ``+v`` one.  With
        ``use_kernel`` the sketch delta is one launch of the scatter kernel
        (``kernels.ops.sketch_sparse_vector``, B = 1) and the candidate
        refresh's estimates one launch of the estimate kernel; the refresh
        policy is ``worp``'s either way."""
        keys = self._tensor(keys, torch.int32)
        values = self._tensor(values, torch.float32)
        if not use_kernel:
            self.state = worp.onepass_update(self.state, keys, values,
                                             self.p)
            return
        from repro_torch.kernels import ops as kernel_ops

        st = self.state
        sk = st.sketch
        delta = kernel_ops.sketch_sparse_vector(
            keys, values, sk.rows, sk.width, sk.seed, p=self.p,
            transform_seed=st.seed_transform)
        sk = countsketch.CountSketch(table=sk.table + delta, seed=sk.seed)
        all_keys = torch.cat([st.cand_keys, keys])
        est = torch.abs(kernel_ops.estimate(sk.table, all_keys, sk.seed))
        self.state = worp.OnePassState(
            sketch=sk,
            cand_keys=worp._refresh_from_estimates(all_keys, est,
                                                   st.cand_keys.shape[-1]),
            seed_transform=st.seed_transform)

    def merge_from(self, other: "FrequencySketcher"):
        self.state = worp.onepass_merge(self.state, other.state)

    def sample(self):
        return worp.onepass_sample(self.state, self.k, self.p)

    def selection_weights(self, tokens) -> torch.Tensor:
        """Per-token weights nu_hat^p for the sampled heavy tokens, 1 for the
        tail -- down-weighting frequent examples when p < 1 is interpreted as
        weighting BY the inverse ratio (freq/heavy)^p."""
        s = self.sample()
        shape = tuple(np.shape(tokens))
        flat = self._tensor(tokens, torch.int32)
        eq = flat[:, None] == s.keys[None, :]
        est = torch.sum(torch.where(eq, torch.abs(s.freqs)[None, :], 0.0),
                        dim=1)
        ref = torch.max(torch.abs(s.freqs))
        w = torch.where(est > 0, (est / ref) ** torch.tensor(
            -self.p, dtype=torch.float32, device=self.device), 1.0)
        return w.reshape(shape)
