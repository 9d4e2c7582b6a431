"""The benchmark's plain reference agrees with the program at a tiny size
on the CPU, and imports nothing of the program."""
from __future__ import annotations

import ast
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import gradcomp as ref_gradcomp
from perfbench.reference import hashing as ref_hashing
from perfbench.reference import sketch

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "collections", "typing", "math",
               "__future__"}
    for path in REF_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:      # the reference's own modules
                    continue
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)


def test_frozen_hash_equals_the_programs():
    from repro_torch.core import hashing

    g = torch.Generator().manual_seed(1)
    keys = torch.randint(0, 2**32, (4096,), generator=g, dtype=torch.int64)
    salts = torch.randint(0, 2**32, (4096,), generator=g, dtype=torch.int64)
    assert torch.equal(ref_hashing.hash_u32(keys, salts),
                       hashing.hash_u32(keys, salts))
    assert torch.equal(ref_hashing.uniform01(keys, salts),
                       hashing.uniform01(keys, salts).to(torch.float64))
    b, s = ref_hashing.bucket_sign(keys, salts, 2048)
    assert torch.equal(b, hashing.bucket_hash(keys, salts, 2048))
    assert torch.equal(s.to(torch.float32), hashing.sign_hash(keys, salts))
    assert torch.equal(ref_hashing.row_salt(salts, 3),
                       hashing.row_salt(salts, 3))


def test_stream_seeds_equal_the_engines():
    from repro_torch.engine import EngineConfig, derive_stream_seeds

    cfg = EngineConfig(num_streams=16, seed=0xDEADBEEF)
    sk, ts = derive_stream_seeds(cfg, device="cpu")
    rsk, rts = ref_hashing.stream_seeds(16, 0xDEADBEEF, "cpu")
    assert torch.equal(sk, rsk) and torch.equal(ts, rts)


def test_transform_keeps_the_u_equal_one_edge():
    """Key 17691050 under transform seed 0 draws u == 1.0 (r = -0.0): the
    program's transformed value is -inf, and the reference's too."""
    from repro_torch.core import transforms

    key = torch.tensor([17691050])
    f = ref_hashing.transform_factor(key, torch.tensor([0]), 1.0, "ppswor")
    prog = transforms.transform_values(key, torch.tensor([1.0]), 1.0,
                                       torch.tensor([0]))
    assert float(f) == float(prog) == float("-inf")


def _batch(B=6, n=300, vocab=500, seed=2):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, vocab, (B, n), generator=g, dtype=torch.int32)
    keys[:, -7:] = -1
    vals = torch.randn((B, n), generator=g)
    return keys, vals


def test_scatter_and_estimate_agree_with_the_program():
    from repro_torch.core import countsketch, worp
    from repro_torch.engine import EngineConfig, SketchEngine

    keys, vals = _batch()
    cfg = EngineConfig(num_streams=6, width=64, candidates=32, seed=77)
    eng = SketchEngine(cfg, device="cpu")
    eng.update(keys, vals)
    seeds, tseeds = ref_hashing.stream_seeds(6, 77, "cpu")
    table = sketch.scatter(keys, vals, seeds, tseeds, 7, 64, 1.0, "ppswor")
    got = eng.state.sketch.table.to(torch.float64)
    absum = sketch.scatter(keys, vals, seeds, tseeds, 7, 64, 1.0, "ppswor",
                           absolute=True)
    assert float(((got - table).abs() / absum.clamp(min=1e-30)).max()) < 1e-5
    probe = torch.cat([keys[:, :40], torch.full((6, 2), -1)], 1)
    est = sketch.estimate(table, probe, seeds)
    want = countsketch.estimate(
        countsketch.CountSketch(table=table, seed=seeds), probe.long())
    assert torch.allclose(est[:, :40], want[:, :40], rtol=0, atol=0)
    assert bool(torch.isnan(est[:, 40:]).all())
    # the candidate rule: the same keys as the program's buffer
    cand = sketch.refresh_keys(table, seeds, torch.full((6, 32), -1),
                               keys, 32)
    prog = worp.refresh_candidates(
        countsketch.CountSketch(table=table, seed=seeds),
        torch.full((6, 32), -1, dtype=torch.int32), keys)
    for b in range(6):
        assert set(cand[b].tolist()) == set(prog[b].tolist())


def test_dense_candidates_agree_with_the_program():
    from repro_torch.engine import EngineConfig, SketchEngine

    from perfbench.reference import onepass

    g = torch.Generator().manual_seed(4)
    lengths = [90, 300, 17]
    vals = torch.randn((3, 300), generator=g)
    cfg = EngineConfig(num_streams=3, width=64, candidates=16, seed=5)
    eng = SketchEngine(cfg, device="cpu")
    eng.update_dense(vals, lengths=np.asarray(lengths))
    seeds, tseeds = ref_hashing.stream_seeds(3, 5, "cpu")
    keys, ok = sketch.dense_keys(lengths, 300, "cpu")
    table = sketch.scatter(keys, vals, seeds, tseeds, 7, 64, 1.0, "ppswor",
                           valid=ok)
    _, top = onepass.dense_top(table, seeds, lengths, 300, 16)
    for b in range(3):
        assert set(top[b].tolist()) == set(
            eng.state.cand_keys[b].tolist())
    assert onepass.dense_refresh_gap(table, seeds, lengths, 300,
                                     eng.state.cand_keys) == 0.0


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist

    d = tempfile.mkdtemp(prefix="perfbench-test-store-")
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["twopass", "onepass"])
def test_gradcomp_step_agrees_with_the_program(one_rank_group, mode):
    from repro_torch.optim import gradcomp

    g = torch.Generator().manual_seed(8)
    shapes = {"a": (40, 30), "b": (700,), "c": (64,)}
    grads = {k: torch.randn(s, generator=g) * 3 for k, s in shapes.items()}
    err = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    cc = gradcomp.CompressorConfig(width=64, seed=123, mode=mode)
    sparse, new_err, stats = gradcomp.tree_compress_step_engine(
        grads, err, cc, k_per_leaf=8, cand_per_leaf=16)
    got = ref_gradcomp.check(grads, err, sparse, new_err,
                             float(stats["comm_bytes"]), cc, 8, 16)
    assert got["ids_gap"] < 1e-6 and got["cand_gap"] == 0.0
    assert got["value_err"] < 1e-5 and got["error_err"] < 1e-6
    assert got["comm_bytes_err"] == 0.0
    rs, re_, _ = ref_gradcomp.step(grads, err, cc, 8, 16)
    for k in shapes:
        assert torch.equal(rs[k] != 0, sparse[k] != 0)
