"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the float32 the configurations state.  The
benchmark's checks must find it not correct; it never runs in a benchmark
run (``perfbench/readings.py --program control`` runs it)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import gradcomp, hashing, onepass, sketch

DTYPE = torch.bfloat16


class _Sketch(NamedTuple):
    table: torch.Tensor


class _State(NamedTuple):
    sketch: _Sketch
    cand_keys: torch.Tensor


class _Sample(NamedTuple):
    keys: torch.Tensor
    freqs: torch.Tensor
    threshold: torch.Tensor
    transformed: torch.Tensor


class ControlEngine:
    """A one-pass WORp engine of B streams in bfloat16, with the program's
    calls (``update``, ``ingest``, ``flush``, ``update_dense``,
    ``sample``, ``state``)."""

    def __init__(self, engine: dict, seed: int, device):
        B = engine["num_streams"]
        self.rows, self.width = engine["rows"], engine["width"]
        self.c, self.p = engine["candidates"], engine["p"]
        self.scheme = engine["scheme"]
        self.seeds, self.tseeds = hashing.stream_seeds(B, seed, device)
        self.table = torch.zeros((B, self.rows, self.width), dtype=DTYPE,
                                 device=device)
        self.cand = torch.full((B, self.c), -1, dtype=torch.int32,
                               device=device)
        self.device = torch.device(device)

    @property
    def state(self) -> _State:
        return _State(_Sketch(self.table), self.cand)

    def update(self, keys, values):
        keys = torch.as_tensor(keys, device=self.device)
        values = torch.as_tensor(values, device=self.device)
        self.table = self.table + sketch.scatter(
            keys, values, self.seeds, self.tseeds, self.rows, self.width,
            self.p, self.scheme, dtype=DTYPE)
        self.cand = sketch.refresh_keys(self.table, self.seeds, self.cand,
                                        keys, self.c).to(torch.int32)
        return self

    def ingest(self, keys, values):
        return self.update(torch.from_numpy(np.asarray(keys)),
                           torch.from_numpy(np.asarray(values)))

    def flush(self):
        return self

    def update_dense(self, values, lengths=None):
        B, n = values.shape
        lengths = [n] * B if lengths is None else lengths
        keys, ok = sketch.dense_keys(lengths, n, self.device)
        self.table = self.table + sketch.scatter(
            keys, values, self.seeds, self.tseeds, self.rows, self.width,
            self.p, self.scheme, dtype=DTYPE, valid=ok)
        _, top = onepass.dense_top(self.table, self.seeds, lengths, n,
                                   self.c)
        self.cand = top.to(torch.int32)
        return self

    def sample(self, k: int) -> _Sample:
        est = sketch.estimate(self.table, self.cand, self.seeds)
        prio = torch.where(self.cand == -1, -torch.inf,
                           sketch.priority(est))
        order = torch.sort(prio, dim=1, descending=True, stable=True).indices
        sel = torch.gather(self.cand, 1, order[:, :k])
        est_sel = torch.gather(est, 1, order[:, :k])
        inv = hashing.inverse_factor(hashing.u32(sel), self.tseeds[:, None],
                                     self.p, self.scheme).to(DTYPE)
        freqs = torch.where(sel == -1, 0.0, (est_sel * inv).float())
        thr = torch.gather(prio, 1, order[:, k:k + 1])[:, 0]
        return _Sample(sel, freqs, thr.float(), est_sel.float())


def compress_step(grads: dict, error: dict, cc, group=None,
                  k_per_leaf: int = 32, cand_per_leaf: int = 64):
    """``tree_compress_step_engine`` computed by the reference in bfloat16
    (one rank)."""
    return gradcomp.step(grads, error, cc, k_per_leaf, cand_per_leaf,
                         dtype=DTYPE)
