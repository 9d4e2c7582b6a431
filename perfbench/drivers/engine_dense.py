"""``engine_dense``: B dense segments (the per-leaf gradient streams of a
model layer) through ``SketchEngine.update_dense`` with the lengths on the
host, then ``sample(k)``, a step a cycle.

Traffic parameters: ``k``, ``pool`` (distinct gradient steps replayed),
``log_scale`` (each coordinate's fixed scale exp(log_scale * g)),
``warm_steps``, ``trace_cycles``, ``checked`` (sampled steps checked
besides the first and the last).

Checked: the final table, and at each checked step the candidates (every
key of a segment enters each update, so the candidate rule ranks all of
them) and the sample.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import traffic_gen
from perfbench.drivers import Base
from perfbench.reference import compare, hashing, onepass, sketch


def leaf_sizes(config: dict) -> list:
    """The numbers of coordinates of the configuration's leaves, in sorted
    order of their names (the order a parameter tree's leaves take)."""
    return [math.prod(shape) for _, shape in sorted(config["leaves"])]


class Driver(Base):
    def setup(self):
        cfg, tr = self.config, self.traffic
        self.eng_cfg = dict(cfg["engine"], num_streams=len(cfg["leaves"]))
        self.sizes = leaf_sizes(cfg)
        self.n = max(self.sizes)
        self.lengths = np.asarray(self.sizes, np.int64)
        self.k = int(tr["k"])
        self.engine_seed = self.seed & hashing.MASK32
        self.pool = traffic_gen.gradient_pool(
            self.sizes, float(tr["log_scale"]), int(tr["pool"]), self.seed,
            self.device)
        self.inputs_made(self.pool)
        self.prog = self._program()
        self.log: list = []
        self.next = 0
        self.steps = 0
        for _ in range(int(tr.get("warm_steps", 2))):
            self.cycle()
        self.sync()

    def _program(self):
        from repro_torch.engine import EngineConfig, SketchEngine

        if self.program == "control":
            from perfbench.reference.control import ControlEngine

            return ControlEngine(self.eng_cfg, self.engine_seed, self.device)
        eng = SketchEngine(EngineConfig(**{**self.eng_cfg,
                                           "seed": self.engine_seed}),
                           device=self.device)
        return self.program(eng) if callable(self.program) else eng

    def cycle(self):
        slot = self.reservoir.offer() if self.in_window else None
        j = self.next % self.pool.shape[0]
        self.next += 1
        with record_function("bench.update"):
            self.prog.update_dense(self.pool[j], lengths=self.lengths)
        with record_function("bench.sample"):
            s = self.prog.sample(self.k)
            keys, freqs = s.keys.cpu(), s.freqs.cpu()
        self.log.append(j)
        rec = {"u": len(self.log) - 1,
               "cand": self.prog.state.cand_keys,
               "sample": (keys, freqs, s.threshold)}
        self.checkpoints.setdefault("start", rec)
        self.checkpoints["last"] = rec
        if slot is not None:
            self.checkpoints[f"kept{slot}"] = rec
        if self.in_window:
            self.steps += 1
            self.window_ops += 1

    def start_window(self):
        super().start_window()
        self.steps = 0

    def end_metrics(self, window_s: float) -> dict:
        return {"step_ms": window_s * 1e3 / self.steps}

    def facts(self) -> dict:
        rows, width = self.eng_cfg["rows"], self.eng_cfg["width"]
        stage = {"live_slots": sum(self.sizes), "rows": rows,
                 "table_bytes": len(self.sizes) * rows * width * 4}
        return {"dense.sketch": stage, "dense.refresh": stage}

    def release(self):
        self.final_table = self.prog.state.sketch.table
        self.prog = None

    def checks(self) -> dict:
        e = self.eng_cfg
        B = len(self.sizes)
        seeds, tseeds = hashing.stream_seeds(B, self.engine_seed,
                                             self.device)

        def delta_of(j, absolute):
            keys, ok = sketch.dense_keys(self.lengths, self.n, self.device)
            return sketch.scatter(keys, self.pool[j], seeds, tseeds,
                                  e["rows"], e["width"], e["p"], e["scheme"],
                                  absolute=absolute, valid=ok)

        targets = {name: rec["u"] for name, rec in self.checkpoints.items()}
        targets["final"] = len(self.log) - 1
        tabs, absum = onepass.tables(self.log, targets, delta_of, "final")
        out = {"table_err": compare.table_err(self.final_table,
                                              tabs["final"], absum),
               "refresh_gap": 0.0, "sample_gap": 0.0, "sample_err": 0.0}
        for name, rec in self.checkpoints.items():
            table = tabs[name]
            out["refresh_gap"] = max(out["refresh_gap"],
                                     onepass.dense_refresh_gap(
                                         table, seeds, self.lengths, self.n,
                                         rec["cand"]))
            keys, freqs, thr = (x.to(self.device) for x in rec["sample"])
            gap, err = onepass.sample_errs(
                table, seeds, tseeds, rec["cand"], keys, freqs, thr, self.k,
                e["p"], e["scheme"])
            out["sample_gap"] = max(out["sample_gap"], gap)
            out["sample_err"] = max(out["sample_err"], err)
        self.nonfinite_streams = int((~torch.isfinite(tabs["final"]))
                                     .flatten(1).any(1).sum())
        return out
