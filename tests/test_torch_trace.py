"""The program's spans (``repro_torch.trace.span``): the tree that a
``torch.profiler`` trace of each benchmark cell's cycle holds, read back
through ``perfbench.chrometrace.Trace``, and no RecordFunction entered
while no profiler collects.

Each cell's driver runs the program as the benchmark does, at the tiny
sizes of ``perfbench/tests/tiny.py``: ``SketchEngine.update`` + ``sample``
(the sparse plane), ``update_dense`` + ``sample``,
``tree_compress_step_engine`` over a one-rank gloo group, and the engine
compressed train step of granite-4.0-h at its rehearsal widths."""
from __future__ import annotations

import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness
from perfbench.chrometrace import Trace
from perfbench.tests import tiny
from repro_torch.trace import span

CYCLES = 2

# span: (instances a cycle, parent), the parent the innermost range around
# the span on its thread (a tuple: one of them); ``bench.*`` are the
# drivers' own ranges
TREES = {
    "tenants4096.device_stream": {
        "sparse.scatter": (4, "bench.update"),
        "sparse.refresh": (4, "bench.update"),
        "refresh.estimate": (4, "sparse.refresh"),
        "dedup.sort": (4, "sparse.refresh"),
        "dedup.segsum": (4, "sparse.refresh"),
        "dedup.topc": (4, "sparse.refresh"),
        "engine.sample": (1, "bench.sample"),
        "sample.estimate": (1, "engine.sample"),
        "sample.select": (1, "engine.sample"),
    },
    "phi4mini_grad.engine_dense": {
        "dense.sketch": (1, "bench.update"),
        "dense.refresh": (1, "bench.update"),
        "refresh.estimate": (1, "dense.refresh"),
        "dedup.sort": (1, "dense.refresh"),
        "dedup.segsum": (1, "dense.refresh"),
        "dedup.topc": (1, "dense.refresh"),
        "engine.sample": (1, "bench.sample"),
        "sample.estimate": (1, "engine.sample"),
        "sample.select": (1, "engine.sample"),
    },
    "phi4mini_grad.gradcomp_step": {
        "gradcomp.step": (1, "bench.step"),
        "gradcomp.accumulate": (1, "gradcomp.step"),
        "gradcomp.sketch": (1, "gradcomp.step"),
        "gradcomp.candidates": (1, "gradcomp.step"),
        "gradcomp.decode": (1, "gradcomp.step"),
        "gradcomp.leaf_update": (1, "gradcomp.step"),
        "gradcomp.stats": (1, "gradcomp.step"),
        "sample.estimate": (1, "gradcomp.decode"),
        "sample.select": (1, "gradcomp.decode"),
    },
    # one period of 10 layers (9 Mamba-2, 1 attention), each opened twice
    # a step: in the forward and again when backward recomputes it (on the
    # CPU, autograd runs the backward on the step's own thread)
    "granite4h_small.compressed_train": {
        "train.grad": (1, "bench.step"),
        "layer.mamba": (18, "train.grad"),
        "layer.attn": (2, "train.grad"),
        "ssd.scan": (18, "layer.mamba"),
        "moe.route": (20, ("layer.mamba", "layer.attn")),
        "moe.experts": (20, ("layer.mamba", "layer.attn")),
        "moe.shared": (20, ("layer.mamba", "layer.attn")),
        "gradcomp.step": (1, "bench.step"),
        "gradcomp.accumulate": (1, "gradcomp.step"),
        "gradcomp.sketch": (1, "gradcomp.step"),
        "gradcomp.candidates": (1, "gradcomp.step"),
        "gradcomp.decode": (1, "gradcomp.step"),
        "gradcomp.leaf_update": (1, "gradcomp.step"),
        "gradcomp.stats": (1, "gradcomp.step"),
        "sample.estimate": (1, "gradcomp.decode"),
        "sample.select": (1, "gradcomp.decode"),
        "train.optim": (1, "bench.step"),
    },
}
PROGRAM = {name for tree in TREES.values() for name in tree}


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def driver(tmp_path, request):
    root = tiny.make(tmp_path)
    w = harness.workload(harness.benchmark(root), request.param)
    cfg = harness.load(root, "configs", f"{w['config']}.json")
    tr = harness.load(root, "traffic", f"{w['traffic']}.json")
    mod = importlib.import_module(f"perfbench.drivers.{tr['driver']}")
    drv = mod.Driver(cfg, tr, 2**31 + 5, "cpu")
    try:
        drv.setup()
        yield request.param, drv
    finally:
        drv.close()


def _parent(span_, spans):
    around = [s for s in spans if s is not span_ and s.tid == span_.tid
              and s.start <= span_.start and span_.end <= s.end]
    return min(around, key=lambda s: s.end - s.start).name if around \
        else None


@pytest.mark.parametrize("driver", list(TREES), indirect=True)
def test_program_spans_nest_as_the_stages_call(driver, tmp_path):
    cell, drv = driver
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            drv.start_window()
            for _ in range(CYCLES):
                drv.cycle()
            drv.end_window()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tr = Trace.load(path)
    spans = [s for v in tr.ranges.values() for s in v]
    tree = TREES[cell]
    seen = {name for name in tr.ranges if name in PROGRAM}
    assert seen == set(tree), (cell, sorted(seen))
    for name, (per_cycle, parent) in tree.items():
        got = tr.spans(name)
        assert len(got) == per_cycle * CYCLES, (name, len(got))
        parents = set(parent) if isinstance(parent, tuple) else {parent}
        assert {_parent(s, spans) for s in got} == parents, name


@pytest.mark.parametrize("driver", list(TREES), indirect=True)
def test_span_enters_no_record_function_without_a_profiler(driver,
                                                           monkeypatch):
    """With no profiler on, a cycle enters only the driver's own ranges,
    and ``span`` hands out one shared no-op context."""
    _, drv = driver
    entered = []
    real = record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(record_function, "__enter__", counting)
    drv.cycle()
    assert entered and all(n.startswith("bench.") for n in entered), entered
    assert span("a") is span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("a")
        assert isinstance(on, record_function)
    assert span("a") is span("b")
