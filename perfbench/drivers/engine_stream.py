"""``engine_stream``: B turnstile streams through ``SketchEngine``, a
sample after every few updates, in a closed loop.

Traffic parameters: ``source`` ("device": ``SketchEngine.update`` of
batches already on the card; "host": numpy batches through
``SketchEngine.ingest`` and the plane's flush), ``plane`` and ``sampler``
(any registered), ``flush_elems`` (the host source's ``FlushPolicy``; at
most a batch's width, so each batch is one flush), ``inserts`` and
``retract_share`` (a batch's width), ``updates_per_sample``, ``k``,
``pool`` (distinct batches replayed), ``warm_cycles``, ``trace_cycles`` and
``checked`` (sampled cycles checked besides the last).

Checked: the final table (every update worked out from the inputs), the
candidate rule at the priming update, at each checked cycle's last update
and at the last cycle's (device source), and each checked sample.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench import traffic_gen
from perfbench.drivers import Base
from perfbench.reference import hashing, onepass, sketch


class Driver(Base):
    def setup(self):
        cfg, tr = self.config, self.traffic
        self.eng_cfg = dict(cfg["engine"])
        self.B = self.eng_cfg["num_streams"]
        self.k = int(tr["k"])
        self.updates_per_sample = int(tr["updates_per_sample"])
        self.source = tr.get("source", "device")
        self.sampler = tr.get("sampler", self.eng_cfg.get("sampler",
                                                          "onepass"))
        self.engine_seed = self.seed & hashing.MASK32
        self.pool = traffic_gen.zipf_turnstile_pool(
            self.B, int(tr["inserts"]), float(tr["retract_share"]),
            float(cfg["data"]["alpha"]), int(cfg["data"]["vocab"]),
            int(tr["pool"]), self.seed, self.device)
        self.inputs_made(*self.pool)
        self.n = self.pool.keys.shape[2]
        self.live = [int(x) for x in (self.pool.keys != -1).flatten(1).sum(1)]
        self.prime_live = int((self.pool.prime_keys != -1).sum())
        if self.source == "host":
            if int(tr["flush_elems"]) > self.n:
                raise ValueError("flush_elems must be at most a batch's "
                                 "width: one flush a batch")
            self.host = [(self.pool.keys[j].cpu().numpy(),
                          self.pool.values[j].cpu().numpy())
                         for j in range(self.pool.keys.shape[0])]
        elif self.source != "device":
            raise ValueError(f"unknown source {self.source!r}")
        self.prog = self._program()
        self.log: list = []
        self.next = 0
        self.sample_ms: list = []
        self.events = 0
        cand0 = self._cand()
        self._apply("prime")
        self.checkpoints["start"] = {"u": 0, "batch": "prime",
                                     "before": cand0, "cand": self._cand(),
                                     "sample": None}
        for _ in range(int(tr.get("warm_cycles", 2))):
            self.cycle()
        self.sync()

    def _program(self):
        from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine

        if self.program == "control":
            from perfbench.reference.control import ControlEngine

            return ControlEngine(self.eng_cfg, self.engine_seed, self.device)
        ec = EngineConfig(**{**self.eng_cfg, "seed": self.engine_seed,
                             "sampler": self.sampler})
        eng = SketchEngine(
            ec, plane=self.traffic.get("plane", "sparse"),
            flush=FlushPolicy(max_elems=int(self.traffic.get(
                "flush_elems", 4096))), device=self.device)
        return self.program(eng) if callable(self.program) else eng

    def _cand(self):
        st = self.prog.state
        if self.sampler == "twopass":
            st = st.pass1
        return st.cand_keys

    def _apply(self, batch):
        if batch == "prime":
            keys, vals = self.pool.prime_keys, self.pool.prime_values
            if self.source == "host":
                keys, vals = keys.cpu().numpy(), vals.cpu().numpy()
        elif self.source == "host":
            keys, vals = self.host[batch]
        else:
            keys, vals = self.pool.keys[batch], self.pool.values[batch]
        with record_function("bench.update"):
            if self.source == "host":
                self.prog.ingest(keys, vals)
            else:
                self.prog.update(keys, vals)
        self.log.append(batch)
        if self.in_window:
            self.events += self.live[batch] if batch != "prime" \
                else self.prime_live
            self.window_ops += 1

    def cycle(self):
        slot = self.reservoir.offer() if self.in_window else None
        P = self.pool.keys.shape[0]
        before = None
        for i in range(self.updates_per_sample):
            j = self.next % P
            self.next += 1
            if i == self.updates_per_sample - 1 and (
                    slot is not None or self.source == "device"):
                before = self._cand()
            self._apply(j)
        with record_function("bench.drain"):
            if self.source == "host":
                self.prog.flush()
            self.sync()
        t0 = time.perf_counter()
        with record_function("bench.sample"):
            s = self.prog.sample(self.k)
            keys, freqs = s.keys.cpu(), s.freqs.cpu()
        if self.in_window:
            self.sample_ms.append((time.perf_counter() - t0) * 1e3)
            self.window_ops += 1
        rec = {"u": len(self.log) - 1, "batch": self.log[-1],
               "before": before, "cand": self._cand(),
               "sample": (keys, freqs, s.threshold)}
        self.checkpoints["last"] = rec
        if slot is not None:
            self.checkpoints[f"kept{slot}"] = rec

    def start_window(self):
        super().start_window()
        self.events = 0
        self.sample_ms = []

    def end_metrics(self, window_s: float) -> dict:
        out = {"events_per_s": self.events / window_s}
        if self.sample_ms:
            s = sorted(self.sample_ms)
            out["sample_p95_ms"] = s[max(0, -(-95 * len(s) // 100) - 1)]
        return out

    def facts(self) -> dict:
        rows, width = self.eng_cfg["rows"], self.eng_cfg["width"]
        table = self.B * rows * width * 4
        stage = {"live_slots": self.live[0], "table_bytes": table,
                 "rows": rows}
        return {"sparse.scatter": stage, "sparse.refresh": stage}

    def release(self):
        st = self.prog.state
        if self.sampler == "twopass":
            st = st.pass1
        self.final_table = st.sketch.table
        plane = getattr(self.prog, "plane", None)
        if plane is not None:
            plane.close()
        self.prog = None

    # -- the reference -------------------------------------------------
    def checks(self) -> dict:
        if self.sampler not in ("onepass", "twopass"):
            raise ValueError(f"no reference for sampler {self.sampler!r}")
        e = self.eng_cfg
        seeds, tseeds = hashing.stream_seeds(self.B, self.engine_seed,
                                             self.device)

        def delta_of(batch, absolute):
            if batch == "prime":
                keys, vals = self.pool.prime_keys, self.pool.prime_values
            else:
                keys, vals = self.pool.keys[batch], self.pool.values[batch]
            return sketch.scatter(keys, vals, seeds, tseeds, e["rows"],
                                  e["width"], e["p"], e["scheme"],
                                  absolute=absolute)

        targets = {name: rec["u"] for name, rec in self.checkpoints.items()}
        targets["final"] = len(self.log) - 1
        tabs, absum = onepass.tables(self.log, targets, delta_of, "final")
        out = {"table_err": self._table_err(tabs["final"], absum),
               "refresh_gap": 0.0, "sample_gap": 0.0, "sample_err": 0.0}
        for name, rec in self.checkpoints.items():
            table = tabs[name]
            if rec["before"] is not None:
                batch = rec["batch"]
                keys = self.pool.prime_keys if batch == "prime" \
                    else self.pool.keys[batch]
                out["refresh_gap"] = max(out["refresh_gap"],
                                         onepass.refresh_gap(
                                             table, seeds, rec["before"],
                                             keys, rec["cand"]))
            if rec["sample"] is not None and self.sampler == "onepass":
                keys, freqs, thr = (x.to(self.device) for x in rec["sample"])
                gap, err = onepass.sample_errs(
                    table, seeds, tseeds, rec["cand"], keys, freqs, thr,
                    self.k, e["p"], e["scheme"])
                out["sample_gap"] = max(out["sample_gap"], gap)
                out["sample_err"] = max(out["sample_err"], err)
        self.nonfinite_streams = int((~torch.isfinite(tabs["final"]))
                                     .flatten(1).any(1).sum())
        return out

    def _table_err(self, want, absum) -> float:
        from perfbench.reference import compare

        return compare.table_err(self.final_table, want, absum)
