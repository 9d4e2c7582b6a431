"""A copy of the benchmark's data files at sizes a CPU test can hold: the
same cells, metrics and checks, each configuration cut to a few streams of
a few hundred keys (every other setting as the cell runs it)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

TINY_ENGINE = {"num_streams": 8, "width": 64, "candidates": 32}
TINY_LEAVES = [["ln1", [2, 48]], ["ln2", [2, 48]], ["wg", [2, 48, 128]],
               ["wi", [2, 48, 128]], ["wk", [2, 48, 16]], ["wo", [2, 48, 48]],
               ["wo_mlp", [2, 128, 48]], ["wq", [2, 48, 48]],
               ["wv", [2, 48, 16]]]
TINY_TRAFFIC = {"inserts": 256, "k": 8, "pool": 3, "k_per_leaf": 8,
                "cand_per_leaf": 16, "warm_cycles": 1, "warm_steps": 1}


def _edit(path: Path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def _tiny_config(cfg: dict):
    if "leaves" in cfg:
        cfg["leaves"] = TINY_LEAVES
        cfg["engine"].update(width=64, candidates=32)
        cfg["compressor"].update(width=64)
    else:
        cfg["engine"].update(TINY_ENGINE)
        cfg["data"]["vocab"] = 4096


def _tiny_traffic(tr: dict):
    for key, value in TINY_TRAFFIC.items():
        if key in tr:
            tr[key] = value
    if "flush_elems" in tr:
        tr["flush_elems"] = 256


def make(tmp: Path) -> Path:
    """The tiny copy under ``tmp``; returns its ``perfbench`` folder."""
    root = Path(tmp) / "perfbench"
    root.mkdir(parents=True)
    for sub in ("configs", "traffic", "metrics", "checks"):
        shutil.copytree(HERE / sub, root / sub)
    shutil.copy(REPO / "BENCHMARK.json", Path(tmp) / "BENCHMARK.json")
    for p in (root / "configs").glob("*.json"):
        _edit(p, _tiny_config)
    for p in (root / "traffic").glob("*.json"):
        _edit(p, _tiny_traffic)
    return root
