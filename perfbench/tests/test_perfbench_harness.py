"""The harness's shape: its result line, its files found by name, a new
traffic mix as data alone, the host source over the planes, the trace
reader, and its refusals (no card; no program beside it; JAX loaded)."""
from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.chrometrace import Trace

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
QUIET = {"log": lambda *a, **k: None}


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(w):
    root = REPO / "perfbench"
    cfg = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    assert cfg["name"] == w["config"]
    tr = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    importlib.import_module(f"perfbench.drivers.{tr['driver']}")
    assert (root / "checks" / f"{w['name']}.json").exists()
    reported = [m for m in BENCH["per_layer"]
                if harness.applies(m, w["name"])]
    assert reported
    for m in reported:
        spec = json.loads((root / "metrics" / f"{m['name']}.json")
                          .read_text())
        importlib.import_module(f"perfbench.readers.{spec['reader']}")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_result_line_shape(tiny_root, cell):
    r = harness.run(tiny_root, cell, 2**31 + 77, 0.2, False, device="cpu",
                    **QUIET)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    assert "setup_s" in r["metrics"]
    assert r["device"]["platform"] == "cpu"
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r, allow_nan=False)


def test_metrics_apply_by_their_workloads():
    """A per-layer metric is read in the cells it lists and needs the list;
    an end-to-end metric with no list is read in every cell."""
    layer = {"name": "x", "moves": "events_per_s", "workloads": ["a"]}
    assert harness.applies(layer, "a") and not harness.applies(layer, "b")
    with pytest.raises(KeyError):
        harness.applies({"name": "y", "moves": "events_per_s"}, "a")
    assert harness.applies({"name": "setup_s"}, "b")
    assert not harness.applies({"name": "step_ms", "workloads": ["a"]}, "b")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_checked_cycles_come_from_the_window(tiny_root, w):
    """Set-up's warm-up is never among the sampled cycles that the
    reference checks, and the drawn inputs' bytes are noted apart from the
    program's memory."""
    cfg = harness.load(tiny_root, "configs", f"{w['config']}.json")
    tr = harness.load(tiny_root, "traffic", f"{w['traffic']}.json")
    mod = importlib.import_module(f"perfbench.drivers.{tr['driver']}")
    drv = mod.Driver(cfg, tr, 11, "cpu")
    try:
        drv.setup()
        assert drv.input_bytes > 0
        assert not [k for k in drv.checkpoints if k.startswith("kept")]
        drv.start_window()
        for _ in range(3):
            drv.cycle()
        drv.end_window()
        assert [k for k in drv.checkpoints if k.startswith("kept")]
    finally:
        drv.close()


def test_a_new_traffic_mix_runs_from_data_alone(tmp_path, tiny_root):
    """A cell added as data files only: a traffic file, a workload entry
    and its checks file, in a copy of the benchmark; no code edited."""
    tr = json.loads((tiny_root / "traffic" / "device_stream.json")
                    .read_text())
    tr.update(updates_per_sample=2, k=4, retract_share=0.5)
    (tiny_root / "traffic" / "bursty.json").write_text(json.dumps(tr))
    shutil.copy(tiny_root / "checks" / "tenants4096.device_stream.json",
                tiny_root / "checks" / "tenants4096.bursty.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tenants4096.bursty",
                               "config": "tenants4096", "traffic": "bursty",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tenants4096.device_stream" in m.get("workloads", []):
            m["workloads"].append("tenants4096.bursty")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run(tiny_root, "tenants4096.bursty", 5, 0.2, False,
                    device="cpu", **QUIET)
    assert r["correct"] and "events_per_s" in r["metrics"]


@pytest.mark.parametrize("plane,sampler", [("sparse", "onepass"),
                                           ("async", "onepass"),
                                           ("dense", "onepass"),
                                           ("sparse", "twopass")])
def test_host_source_over_planes_and_samplers(tmp_path, tiny_root, plane,
                                              sampler):
    tr = json.loads((tiny_root / "traffic" / "host_ingest.json").read_text())
    tr.update(plane=plane, sampler=sampler)
    (tiny_root / "traffic" / "host_ingest.json").write_text(json.dumps(tr))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tenants4096.host_ingest",
                               "config": "tenants4096",
                               "traffic": "host_ingest", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(tiny_root / "checks" / "tenants4096.device_stream.json",
                tiny_root / "checks" / "tenants4096.host_ingest.json")
    r = harness.run(tiny_root, "tenants4096.host_ingest", 9, 0.2, False,
                    device="cpu", **QUIET)
    assert r["correct"], r["checks"]


def test_trace_reader_counts_kernels_launched_through_ctypes():
    """A range's device time counts every activity whose launch lies in
    the range's span on its thread, whoever launched it."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "tid": 1, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "sparse.scatter",
         "tid": 1, "ts": 100, "dur": 200},
        # a PyTorch op's launch and a ctypes kernel's launch in the range
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 110, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 150, "dur": 5, "args": {"correlation": 8}},
        # another thread's launch at the same time is not the range's
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 2, "ts": 160, "dur": 5, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 120, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "countsketch_scatter",
         "ts": 300, "dur": 500, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 850, "dur": 50,
         "args": {"correlation": 9}},
    ]
    tr = Trace(ev)
    n, seconds, acts = tr.range_device("sparse.scatter")
    assert n == 1 and abs(seconds - 530e-6) < 1e-12
    assert {a.name for a in acts} == {"add", "countsketch_scatter"}
    busy, gaps = tr.busy(tr.window("bench.window"))
    assert abs(busy - 580e-6) < 1e-12
    bd = tr.breakdown(tr.window("bench.window"), gaps)
    assert bd["device_ops"][0] == ["countsketch_scatter", 500e-6]
    idle = dict(bd["idle_gaps"])
    assert abs(idle["sparse.scatter"] - 150e-6) < 1e-12
    assert abs(idle["host"] - (120 + 50 + 100) * 1e-6) < 1e-12
    from perfbench.readers import idle_share, range_launches, roofline
    assert range_launches.read(tr, None, {}, {"range": "sparse.scatter"}) \
        == 2
    assert abs(idle_share.read(tr, tr.window("bench.window"), {}, {})
               - 42.0) < 1e-9
    facts = {"sparse.scatter": {"live_slots": 1e6, "table_bytes": 0,
                                "rows": 7}}
    spec = {"range": "sparse.scatter", "bytes": [["live_slots", 8]],
            "ops": [["live_slots", "slot_ops"]]}
    share = roofline.read(tr, None, facts, spec)
    assert 0 < share < 100


def test_foreign_modules_compare_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FOREIGN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.foreign_modules() == ["jaxlib", "repro.core"]


def test_no_jax_after_each_drivers_set_up(tmp_path):
    """In a fresh interpreter, set up and run every cell's driver; no
    module of JAX or of the JAX package is loaded."""
    script = f"""
import sys
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
import torch
torch.set_num_threads(1)
from perfbench import harness
from perfbench.tests import tiny
root = tiny.make({str(tmp_path)!r})
for cell in {[w['name'] for w in BENCH['workloads']]!r}:
    harness.run(root, cell, 3, 0.1, False, device="cpu",
                log=lambda *a, **k: None)
    assert not harness.foreign_modules(), harness.foreign_modules()
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "clean", \
        out.stderr[-2000:]


def _cli(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "tenants4096.device_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def _json_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("{")]


def test_cli_prints_no_result_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of the refusal")
    out = _cli(REPO)
    assert out.returncode != 0 and not _json_lines(out.stdout)
    assert "CUDA" in out.stderr


def test_cli_fails_with_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/: no program
    to run, so no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and not _json_lines(out.stdout)
