"""``gradcomp_step``: ``optim.gradcomp.tree_compress_step_engine`` over a
one-rank ``torch.distributed`` group (NCCL on the card, gloo on the CPU;
its file store under ``TMPDIR``), the error feedback carried from step to
step, a step a cycle.

Traffic parameters: ``k_per_leaf``, ``cand_per_leaf``, ``compressor``
(``CompressorConfig`` fields other than the seed, which comes from the
run's), ``pool``, ``log_scale``, ``warm_steps``, ``trace_cycles``,
``checked`` (sampled steps checked besides the first and the last).

Checked: each checked step against the reference run from the same
gradients and the error the program carried into it; the first step
starts from the zero error, so it is checked from the inputs alone.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile

import torch
from torch.profiler import record_function

from perfbench import traffic_gen
from perfbench.drivers import Base
from perfbench.drivers.engine_dense import leaf_sizes
from perfbench.reference import gradcomp, hashing


class Driver(Base):
    def setup(self):
        from repro_torch.optim import gradcomp as program_gradcomp

        cfg, tr = self.config, self.traffic
        self.leaves = sorted((name, tuple(shape))
                             for name, shape in cfg["leaves"])
        sizes = leaf_sizes(cfg)
        self.cc = program_gradcomp.CompressorConfig(
            **{**cfg["compressor"], **tr.get("compressor", {}),
               "seed": self.seed & hashing.MASK32})
        self.kw = {"k_per_leaf": int(tr["k_per_leaf"]),
                   "cand_per_leaf": int(tr["cand_per_leaf"])}
        pool = traffic_gen.gradient_pool(sizes, float(tr["log_scale"]),
                                         int(tr["pool"]), self.seed,
                                         self.device)
        self.inputs_made(pool)
        self.trees = [{name: pool[j, b, :math.prod(shape)].view(shape)
                       for b, (name, shape) in enumerate(self.leaves)}
                      for j in range(pool.shape[0])]
        self._init_group()
        if self.program == "control":
            from perfbench.reference import control

            self.step_fn = control.compress_step
        else:
            step = program_gradcomp.tree_compress_step_engine
            self.step_fn = self.program(step) if callable(self.program) \
                else step
        self.error = {name: torch.zeros(shape, dtype=torch.float32,
                                        device=self.device)
                      for name, shape in self.leaves}
        self.next = 0
        self.steps = 0
        for _ in range(int(tr.get("warm_steps", 2))):
            self.cycle()
        self.sync()

    def _init_group(self):
        import torch.distributed as dist

        self.store_dir = tempfile.mkdtemp(prefix="perfbench-store-",
                                          dir=os.environ.get("TMPDIR"))
        store = dist.FileStore(os.path.join(self.store_dir, "store"), 1)
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **kw)

    def cycle(self):
        slot = self.reservoir.offer() if self.in_window else None
        j = self.next % len(self.trees)
        self.next += 1
        grads = self.trees[j]
        with record_function("bench.step"):
            sparse, new_err, stats = self.step_fn(grads, self.error, self.cc,
                                                  None, **self.kw)
            comm = stats["comm_bytes"]
            self.sync()
        rec = {"g": j, "e": self.error, "sparse": sparse, "new_err": new_err,
               "comm": comm}
        self.checkpoints.setdefault("start", rec)
        self.checkpoints["last"] = rec
        if slot is not None:
            self.checkpoints[f"kept{slot}"] = rec
        self.error = new_err
        if self.in_window:
            self.steps += 1
            self.window_ops += 1

    def start_window(self):
        super().start_window()
        self.steps = 0

    def end_metrics(self, window_s: float) -> dict:
        return {"compress_step_ms": window_s * 1e3 / self.steps}

    def facts(self) -> dict:
        return {}

    def release(self):
        self.error = None
        self.step_fn = None

    def checks(self) -> dict:
        out: dict = {}
        for rec in self.checkpoints.values():
            got = gradcomp.check(self.trees[rec["g"]], rec["e"],
                                 rec["sparse"], rec["new_err"],
                                 float(rec["comm"]), self.cc, **self.kw)
            for name, value in got.items():
                out[name] = max(out.get(name, 0.0), value)
        return out

    def close(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.store_dir, ignore_errors=True)
