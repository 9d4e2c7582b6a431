"""Port parity of the slice as a whole: the same seeds and the same
``TurnstileZipfStream`` through the JAX ``SketchEngine(plane="sparse")``
(Pallas kernels in interpret mode) and the port's ``SketchEngine(device=
"cpu", plane="sparse")`` (the kernels' plain versions) give allclose
tables, identical candidate buffers and identical sample keys.

Tables are sums of many transformed values, held to the reference's
scale-aware bound (rtol 1e-4, atol 1e-5 * max(1, max|table|)); candidate
and sample keys are compared exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.pipeline import TurnstileZipfStream as JStream
from repro.engine import EngineConfig as JCfg
from repro.engine import SketchEngine as JEngine
from repro_torch import convert
from repro_torch.data.pipeline import TurnstileZipfStream as TStream
from repro_torch.engine import (EngineConfig, FlushPolicy, SketchEngine,
                                derive_stream_seeds)
from repro_torch.engine import planes as tplanes

ROOT = Path(__file__).resolve().parents[1]


def _assert_tables_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _steps(B, nsteps, n, seed=3, vocab=5000):
    s = TStream(vocab_size=vocab, alpha=1.2, seed=seed)
    out = []
    for t in range(nsteps):
        batches = [s.sparse_batch_at(t, b, n) for b in range(B)]
        out.append((np.stack([k for k, _ in batches]),
                    np.stack([v for _, v in batches])))
    return out


def _pair(B=4, rows=6, width=1000, C=64, p=1.0, scheme="ppswor",
          flush=512, **kw):
    jcfg = JCfg(num_streams=B, rows=rows, width=width, candidates=C, p=p,
                scheme=scheme, **kw)
    tcfg = EngineConfig(num_streams=B, rows=rows, width=width, candidates=C,
                        p=p, scheme=scheme, **kw)
    return (JEngine(jcfg, plane="sparse", flush_elems=flush),
            SketchEngine(tcfg, plane="sparse", flush_elems=flush,
                         device="cpu"))


@pytest.mark.parametrize("rows,width,p,scheme", [
    (6, 1000, 1.0, "ppswor"), (5, 1000, 0.5, "priority"),
    (6, 384, 2.0, "ppswor")])
def test_engine_end_to_end_matches_reference(rows, width, p, scheme):
    je, te = _pair(rows=rows, width=width, p=p, scheme=scheme)
    for keys, vals in _steps(4, 4, 256):
        je.ingest(keys, vals)
        te.ingest(keys, vals)
        assert je.pending == te.pending
    js, tsamp = je.sample(16), te.sample(16)
    _assert_tables_close(te.state.sketch.table.numpy(),
                         je.state.sketch.table)
    assert np.array_equal(te.state.cand_keys.numpy(),
                          np.asarray(je.state.cand_keys))
    assert np.array_equal(tsamp.keys.numpy(), np.asarray(js.keys))
    np.testing.assert_allclose(tsamp.freqs.numpy(), np.asarray(js.freqs),
                               rtol=1e-4)
    est_keys = np.asarray(js.keys)
    np.testing.assert_allclose(te.estimate(est_keys).numpy(),
                               np.asarray(je.estimate(est_keys)), rtol=1e-4)


def test_update_then_ingest_order_matches_reference():
    je, te = _pair(flush=4096)
    (k0, v0), (k1, v1) = _steps(4, 2, 200)
    je.ingest(k0, v0)
    te.ingest(k0, v0)
    je.update(k1, v1)
    te.update(k1, v1)
    assert te.pending == 0
    assert np.array_equal(te.sample(8).keys.numpy(),
                          np.asarray(je.sample(8).keys))


def test_dense_and_sparse_planes_agree():
    cfg = EngineConfig(num_streams=4, rows=6, width=1000, candidates=64)
    sparse = SketchEngine(cfg, plane="sparse", flush_elems=300, device="cpu")
    dense = SketchEngine(cfg, plane="dense", flush_elems=300, device="cpu")
    steps = _steps(4, 3, 256)
    steps[1][0][2, ::3] = -1  # padding slots are ignored by both planes
    for keys, vals in steps:
        sparse.ingest(keys, vals)
        dense.ingest(keys, vals)
    ss, ds = sparse.sample(16), dense.sample(16)
    _assert_tables_close(sparse.state.sketch.table.numpy(),
                         dense.state.sketch.table.numpy())
    assert torch.equal(ss.keys, ds.keys)


def test_stream_is_the_reference_stream():
    t, j = TStream(5000, 1.2, 9), JStream(5000, 1.2, 9)
    for step in range(3):
        for a, b in zip(t.sparse_batch_at(step, 2, 100),
                        j.sparse_batch_at(step, 2, 100)):
            assert np.array_equal(a, b)
        for a, b in zip(t.shard_batch_at(step, 1, 3, 100),
                        j.shard_batch_at(step, 1, 3, 100)):
            assert np.array_equal(a, b)
    assert np.array_equal(t.aggregate_freqs(1, 3, 100),
                          j.aggregate_freqs(1, 3, 100))
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(
        t.event_iterator(50, nsteps=2), j.event_iterator(50, nsteps=2)))


def _jax_leaves(st):
    return (np.asarray(st.sketch.table), np.asarray(st.sketch.seed),
            np.asarray(st.cand_keys), np.asarray(st.seed_transform))


def test_convert_round_trip():
    je, _ = _pair()
    for keys, vals in _steps(4, 2, 200):
        je.ingest(keys, vals)
    je.flush()
    leaves = _jax_leaves(je.state)
    st = convert.onepass_state_from_numpy(*leaves, device="cpu")
    assert st.sketch.seed.dtype == torch.int64
    assert st.cand_keys.dtype == torch.int32
    back = convert.onepass_state_to_numpy(st)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # unbatched states convert too
    one = convert.onepass_state_from_numpy(*(x[1] for x in leaves),
                                           device="cpu")
    assert one.sketch.table.shape == leaves[0].shape[1:]
    with pytest.raises(ValueError, match="batch shapes disagree"):
        convert.onepass_state_from_numpy(leaves[0], leaves[1][:2],
                                         leaves[2], leaves[3], device="cpu")


def test_jax_state_continues_in_port():
    """A JAX engine's state carried into the port, then fed the same
    remaining stream, samples the same keys as the JAX engine does."""
    je, te = _pair()
    steps = _steps(4, 4, 200)
    for keys, vals in steps[:2]:
        je.ingest(keys, vals)
    je.flush()
    te.state = convert.onepass_state_from_numpy(*_jax_leaves(je.state),
                                                device="cpu")
    for keys, vals in steps[2:]:
        je.ingest(keys, vals)
        te.ingest(keys, vals)
    assert np.array_equal(te.sample(16).keys.numpy(),
                          np.asarray(je.sample(16).keys))


def test_merge_and_collapse_match_reference():
    kw = dict(shared_seeds=True)
    ja, ta = _pair(**kw)
    jb, tb = _pair(**kw)
    steps = _steps(4, 2, 200)
    for (keys, vals), (j, t) in zip(steps, ((ja, ta), (jb, tb))):
        j.ingest(keys, vals)
        t.ingest(keys, vals)
    ja.merge_with(jb)
    ta.merge_with(tb)
    assert np.array_equal(ta.state.cand_keys.numpy(),
                          np.asarray(ja.state.cand_keys))
    jc, tc = ja.collapse(), ta.collapse()
    _assert_tables_close(tc.sketch.table.numpy(), jc.sketch.table)
    assert np.array_equal(tc.cand_keys.numpy(), np.asarray(jc.cand_keys))


def test_merge_with_rejects_other_configs():
    _, a = _pair()
    _, b = _pair(seed=7)
    with pytest.raises(ValueError, match="seed="):
        a.merge_with(b)
    with pytest.raises(TypeError):
        a.merge_with(object())
    with pytest.raises(ValueError, match="shared_seeds"):
        a.collapse()


def test_flush_policy_and_buffer():
    cfg = EngineConfig(num_streams=2, rows=5, width=384, candidates=16)
    eng = SketchEngine(cfg, flush=FlushPolicy(max_elems=None, max_bytes=800),
                       device="cpu")
    keys = np.arange(40, dtype=np.int32).reshape(2, 20)
    eng.ingest(keys, np.ones_like(keys, np.float32))
    assert eng.pending == 20 and eng.plane.pending_bytes == 320
    eng.ingest(keys, np.ones_like(keys, np.float32))
    eng.ingest(keys, np.ones_like(keys, np.float32))  # 960 B >= 800 B
    assert eng.pending == 0
    with pytest.raises(ValueError, match="num_streams=2"):
        eng.ingest(keys[:1], np.ones((1, 20), np.float32))


def test_failed_flush_keeps_the_buffer(monkeypatch):
    cfg = EngineConfig(num_streams=2, rows=5, width=384, candidates=16)
    eng = SketchEngine(cfg, flush_elems=10_000, device="cpu")
    keys = np.arange(40, dtype=np.int32).reshape(2, 20)
    eng.ingest(keys, np.ones_like(keys, np.float32))

    def boom(*a, **k):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(tplanes, "ingest_sparse", boom)
    with pytest.raises(RuntimeError, match="out of memory"):
        eng.flush()
    assert eng.pending == 20
    monkeypatch.undo()
    eng.flush()
    assert eng.pending == 0 and eng.state.sketch.table.abs().sum() > 0


def test_not_ported_paths_raise():
    cfg = EngineConfig(num_streams=2, rows=5, width=384, candidates=16)
    eng = SketchEngine(cfg, device="cpu")
    perfect = SketchEngine(cfg, sampler="perfect", device="cpu")
    with pytest.raises(ValueError, match="no dense kernel path"):
        perfect.update_dense(np.zeros((2, 8), np.float32))
    assert eng.freeze().pass2.keys.shape == (2, cfg.capacity)
    with pytest.raises(ValueError, match="second pass"):
        perfect.freeze()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tplanes.make_plane("sparse", eng.spec, eng.state, codec="q8")
    with pytest.raises(ValueError, match="unknown data plane"):
        tplanes.make_plane("fleet", eng.spec, eng.state)
    assert tplanes.available_planes() == ("dense", "sparse", "async",
                                          "pipeline")
    # the perfect oracle holds no sketch: its spec's update; a
    # sketch-backed sampler with no registered path raises
    keys = torch.tensor([[3], [-1]], dtype=torch.int32)
    got = tplanes.ingest_sparse(perfect.spec, perfect.state, keys,
                                torch.ones((2, 1)))
    assert got.freqs[0, 3] == 1 and got.freqs.sum() == 1
    with pytest.raises(NotImplementedError, match="no sparse kernel path"):
        tplanes.ingest_sparse(eng.spec._replace(name="unregistered"),
                              eng.state, keys, torch.zeros((2, 1)))


def test_engine_defaults_to_the_card(monkeypatch):
    """No device means the card; without one the engine raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SketchEngine(EngineConfig(num_streams=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derive_stream_seeds(EngineConfig(num_streams=2))


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.engine, repro_torch.convert\n"
        "import repro_torch.data.pipeline, repro_torch.kernels.build\n"
        "import repro_torch.kernels.ops, repro_torch.core.sampler\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    in a directory that holds nothing else of the repository."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, anywhere
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
