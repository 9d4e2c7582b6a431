"""The benchmark harness: a cell of ``BENCHMARK.json`` run from its files.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``"driver"`` names a module of
``drivers/``); a per-layer metric is ``metrics/<metric>.json``, whose
``"reader"`` names a module of ``readers/``; the limits of the numbers that
decide ``correct`` are ``checks/<cell>.json``.  Nothing here names a cell,
a configuration or a metric: a later cell is data.

A run: set-up (the driver builds its inputs on the device from the seed,
the program, and warms the cell's shapes), the window (closed-loop cycles
for ``seconds``; with ``trace``, then a fixed number of cycles under
``torch.profiler``), the peak memory, then, with the program's state
freed, the reference's checks.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

FOREIGN = frozenset({"jax", "jaxlib", "flax", "repro"})
HERE = Path(__file__).resolve().parent


def load(root: Path, *parts) -> dict:
    with open(Path(root).joinpath(*parts)) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load(Path(root).parent, "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric is read in a cell: a per-layer metric (one that
    ``moves`` another) in the cells its ``workloads`` list; an end-to-end
    metric in those it lists, or in every cell where it lists none."""
    if "moves" in metric or "workloads" in metric:
        return cell in metric["workloads"]
    return True


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FOREIGN)


def _number(x):
    """A JSON number as measured; a non-finite one as its name."""
    x = float(x)
    return x if math.isfinite(x) else str(x)


def run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", program="port", t0: float | None = None,
        log=print) -> dict:
    """One run of ``cell``; returns the result object (with ``checks``)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    root = Path(root)
    bench = benchmark(root)
    w = workload(bench, cell)
    config = load(root, "configs", f"{w['config']}.json")
    traffic = load(root, "traffic", f"{w['traffic']}.json")
    limits = load(root, "checks", f"{cell}.json")
    mod = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    cuda = torch.device(device).type == "cuda"
    drv = mod.Driver(config, traffic, seed, device, program)
    try:
        drv.setup()
        setup_s = time.perf_counter() - t0
        window_s = _window(drv, seconds)
        e2e = dict(drv.end_metrics(window_s), setup_s=setup_s)
        attempted = drv.window_ops
        prof = None
        if trace:
            # after the untraced window, whose host-clock statistics some
            # per-layer metrics read, a few cycles under the profiler
            prof = _traced(drv, int(traffic["trace_cycles"]), cuda)
            attempted += drv.window_ops
        peak = None
        if cuda:
            # the program's own memory: the peak since the driver drew its
            # inputs, less those inputs; the device's peak is the run's
            peak = torch.cuda.max_memory_allocated(device)
            e2e["peak_mem_gb"] = (peak - drv.input_bytes) / 1e9
            peak = max(peak, drv.input_peak)
        facts = dict(drv.facts(), window=e2e)
        drv.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        with torch.no_grad():
            numbers = drv.checks()
    finally:
        drv.close()
    if set(numbers) != set(limits):
        raise ValueError(f"the checks {sorted(numbers)} and their limits "
                         f"{sorted(limits)} differ")
    over = sorted(k for k, v in numbers.items() if not v <= limits[k])
    # an operation of the program that fails raises, and the run prints no
    # result: ``failed`` counts none; the checks' verdict is ``correct``
    result = {"correct": not over, "attempted": attempted, "failed": 0}
    if trace:
        result["metrics"], extra = _per_layer(root, bench, cell, prof,
                                              facts, log)
    else:
        result["metrics"], extra = _end_to_end(bench, cell, e2e, cuda), {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1}
    if peak is not None:
        dev["memory_peak_bytes"] = int(peak)
    dev.update(extra.pop("device", {}))
    result["device"] = dev
    result.update(extra)
    nonfinite = getattr(drv, "nonfinite_streams", None)
    if nonfinite is not None:
        log(f"streams whose reference table holds a non-finite cell: "
            f"{nonfinite}", file=sys.stderr)
    for name in sorted(numbers):
        log(f"check {name} {numbers[name]!r} limit {limits[name]!r} "
            f"{'over' if name in over else 'ok'}", file=sys.stderr)
    result["checks"] = {name: {"value": _number(numbers[name]),
                               "limit": limits[name]}
                        for name in sorted(numbers)}
    return result


def _window(drv, seconds: float) -> float:
    """Closed-loop cycles until ``seconds`` have passed; the window's
    length."""
    drv.start_window()
    while True:
        drv.cycle()
        if time.perf_counter() - drv.t0 >= seconds:
            break
    return drv.end_window()


def _traced(drv, cycles: int, cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            drv.start_window()
            for _ in range(cycles):
                drv.cycle()
            drv.end_window()
    return prof


def _end_to_end(bench: dict, cell: str, e2e: dict, strict: bool) -> dict:
    """The cell's end-to-end metrics; off the card (``strict`` false) the
    ones a CPU run cannot give, such as device memory, are left out."""
    out = {}
    for m in bench["end_to_end"]:
        if not applies(m, cell) or (m["name"] not in e2e and not strict):
            continue
        if m["name"] not in e2e:
            raise ValueError(f"{cell}: the driver measured no "
                             f"{m['name']}")
        out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    return out


def _per_layer(root: Path, bench: dict, cell: str, prof, facts: dict, log):
    from perfbench.chrometrace import Trace

    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json",
                                dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
    finally:
        os.remove(path)
    window = tr.window("bench.window")
    out, extra = {}, {}
    for m in bench["per_layer"]:
        if not applies(m, cell):
            continue
        spec = load(root, "metrics", f"{m['name']}.json")
        reader = importlib.import_module(f"perfbench.readers.{spec['reader']}")
        value = reader.read(tr, window, facts, spec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    for name in facts:
        got = tr.range_device(name)
        if got is None:
            continue
        n, seconds, acts = got
        kernels: dict = {}
        for a in acts:
            kernels[a.name] = kernels.get(a.name, 0.0) + (a.end - a.start)
        top = max(kernels.items(), key=lambda kv: kv[1]) if kernels \
            else ("none", 0.0)
        log(f"range {name}: {n} spans, device {seconds * 1e3:.4f} ms, "
            f"largest activity {top[0][:80]} {top[1] * 1e-3:.4f} ms",
            file=sys.stderr)
    if window is not None:
        busy, gaps = tr.busy(window)
        if busy > 0:
            extra["device"] = {"busy_s": busy,
                               "window_s": (window.end - window.start) * 1e-6}
            extra["breakdown"] = tr.breakdown(window, gaps)
    return out, extra


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = benchmark(HERE)
    chips = int(workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    result = run(HERE, args.workload, args.seed, args.seconds,
                 bool(args.trace), t0=t0)
    foreign = foreign_modules()
    if foreign:
        print("modules of JAX or of the JAX package are loaded: "
              + ", ".join(foreign), file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0
