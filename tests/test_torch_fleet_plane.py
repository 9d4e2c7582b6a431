"""The port's ``fleet`` plane and the codec on its planes, against the JAX
package's, on the CPU.

* The plane order is (dense, sparse, async, pipeline, fleet), whichever
  module is imported first.
* The fleet plane at R = 2 equals the pipeline bit for bit (state and
  sample), under ``none`` and under a lossy codec: the checkpoint publish
  round-trip is an identity under ``none`` and the pipeline's own wire
  crossing under a lossy codec, and the butterfly of two is the pipeline's
  fold.  Its scratch directory goes with ``close``.
* The port's fleet collapse equals the reference's under q8 bit for bit on
  the same replica states, and within the codec's bound fed the same
  stream; the pipeline's lossy collapse is the merge of the roundtripped
  shard states.
* ``FlushPolicy.max_bytes`` budgets wire bytes (the reference's
  ``tests/test_planes.py`` contract), on the synchronous and async planes.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import engine as JE
from repro_torch import convert
from repro_torch.distributed import codecs as C
from repro_torch.distributed import fleet as F
from repro_torch.distributed import pytree
from repro_torch.distributed import sharding as shd
from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine
from repro_torch.engine import planes as P

jax.config.update("jax_platform_name", "cpu")

SAMPLERS = ("onepass", "twopass", "perfect", "tv")


def _cfg(name="onepass", seed=7, **kw):
    base = dict(num_streams=3, rows=3, width=128, candidates=16,
                capacity=16, p=1.0, seed=seed, sampler=name, domain=40,
                num_samplers=8)
    base.update(kw)
    return base


def _batches(nb, seed, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 40, (3, n)).astype(np.int32),
             rng.integers(1, 4, (3, n)).astype(np.float32))
            for _ in range(nb)]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


def _assert_equal(a, b):
    la, lb = pytree.leaves(a), pytree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(C.to_host(x)) == _bits(C.to_host(y))


def _engine(name="onepass", plane="sparse", **kw):
    return SketchEngine(EngineConfig(**_cfg(name)), device="cpu",
                        plane=plane, **kw)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_plane_order_is_the_reference_order():
    assert P.available_planes() == ("dense", "sparse", "async", "pipeline",
                                    "fleet") == JE.available_planes()
    # a fresh interpreter that imports the fleet module first
    code = ("from repro_torch.distributed import fleet\n"
            "from repro_torch.engine import planes\n"
            "print(','.join(planes.available_planes()))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "dense,sparse,async,pipeline,fleet"


def test_fleet_plane_options_and_validation():
    eng = _engine(plane="fleet", plane_opts={"replicas": 3,
                                             "subplane": "async",
                                             "codec": "q8"})
    plane = eng.plane
    assert isinstance(plane, F.FleetPlane) and plane.name == "fleet"
    assert plane.replicas == plane.shards == 3
    assert plane.codec is C.get_codec("q8")
    assert all(isinstance(s, P.AsyncPlane) for s in plane._subplanes)
    assert all(s.codec.name == "none" for s in plane._subplanes)
    plane.close()
    with pytest.raises(ValueError, match="nest"):
        P.make_plane("fleet", eng.spec, eng.state, subplane="fleet")
    with pytest.raises(ValueError, match="unknown codec"):
        _engine(plane="fleet", plane_opts={"codec": "zstd"})


# ---------------------------------------------------------------------------
# the fleet plane against the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["none", "q8"])
@pytest.mark.parametrize("name", SAMPLERS)
def test_fleet_plane_bitwise_equals_pipeline_at_r2(name, codec):
    fleet = _engine(name, "fleet", flush_elems=1,
                    plane_opts={"replicas": 2, "codec": codec})
    pipe = _engine(name, "pipeline", flush_elems=1,
                   plane_opts={"shards": 2, "codec": codec})
    for k, v in _batches(6, seed=3):
        fleet.ingest(k, v)
        pipe.ingest(k, v)
    _assert_equal(fleet.state, pipe.state)
    for a, b in zip(fleet.sample(4), pipe.sample(4)):
        assert _bits(a.numpy()) == _bits(b.numpy())
    scratch = fleet.plane._scratch
    assert scratch is not None and os.path.isdir(scratch)
    fleet.plane.close()
    pipe.plane.close()
    assert fleet.plane._scratch is None and not os.path.exists(scratch)


@pytest.mark.parametrize("codec", ["fp16", "q8", "size_adaptive"])
@pytest.mark.parametrize("shards", [2, 3])
def test_pipeline_lossy_collapse_is_merge_of_roundtripped(shards, codec):
    pipe = _engine(plane="pipeline", flush_elems=1,
                   plane_opts={"shards": shards, "codec": codec})
    for k, v in _batches(5, seed=4):
        pipe.ingest(k, v)
    got = pipe.state
    cdc = C.get_codec(codec)
    subs = [s.state for s in pipe.plane._subplanes]
    want = cdc.roundtrip(subs[0])
    for s in subs[1:]:
        want = pipe.merge_fn(want, cdc.roundtrip(s))
    _assert_equal(got, want)
    # the tables (linear) within the codec's bound of the lossless collapse;
    # the candidate keys follow the quantized estimates
    C.assert_trees_within_codec(
        got.sketch.table, shd.tree_merge(subs, pipe.merge_fn).sketch.table,
        codec, shards=shards, label=codec)


# ---------------------------------------------------------------------------
# against the reference's fleet plane
# ---------------------------------------------------------------------------

def _jax_fleet(name, codec, replicas=2):
    return JE.SketchEngine(JE.EngineConfig(**_cfg(name)), flush_elems=1,
                           plane="fleet",
                           plane_opts={"replicas": replicas, "codec": codec})


@pytest.mark.parametrize("replicas", [2, 3, 4])
@pytest.mark.parametrize("name,codec", [("onepass", "q8"), ("tv", "q8"),
                                        ("perfect", "q8"),
                                        ("twopass", "fp16")])
def test_fleet_collapse_equals_reference_under_q8(name, codec, replicas):
    """The same replica states (the reference's, carried across): the
    port's publish (a q8 checkpoint) and merge give the reference's
    collapse bit for bit.  ``twopass`` crosses fp16: its pass-II priority
    slices hold -inf padding, which q8 turns into all-NaN slices in both
    packages, and their merges order NaN priorities differently."""
    jeng = _jax_fleet(name, codec, replicas)
    eng = _engine(name, "fleet", flush_elems=1,
                  plane_opts={"replicas": replicas, "codec": codec})
    for k, v in _batches(6, seed=5):
        jeng.ingest(k, v)
    jeng.flush()
    for sub, jsub in zip(eng.plane._subplanes, jeng.plane._subplanes):
        sub.set_state(convert.state_from_numpy(
            type(eng.state), [np.asarray(x) for x in
                              jax.tree_util.tree_leaves(jsub.state)], "cpu"))
    eng.plane._merged = None
    got = convert.state_to_numpy(eng.plane.state)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jeng.state)]
    assert [_bits(g) for g in got] == [_bits(w) for w in want]
    assert np.array_equal(eng.sample(4).keys.numpy(),
                          np.asarray(jeng.sample(4).keys))
    eng.plane.close()
    jeng.plane.close()


@pytest.mark.parametrize("codec", ["none", "q8"])
def test_fleet_run_matches_reference_sample(codec):
    """``reference_sample`` fed the same stream in both packages: the same
    sample keys, and states within the codec's bound (the two scatters sum
    in other orders)."""
    batches = _batches(6, seed=6)
    got = F.reference_sample(EngineConfig(**_cfg()), batches, 2, 4,
                             codec=codec, device="cpu")
    from repro.distributed import fleet as JF

    want = JF.reference_sample(JE.EngineConfig(**_cfg()), batches, 2, 4,
                               codec=codec)
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_allclose(got.freqs.numpy(), np.asarray(want.freqs),
                               rtol=2 * C.get_codec(codec).rel_step + 1e-4)


# ---------------------------------------------------------------------------
# the byte budget counts wire bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", ["sparse", "async", "pipeline", "fleet"])
def test_byte_budget_accounts_encoded_payload(plane):
    """Under a lossy codec the pending-byte counter tracks the encoded
    payload (fp16 halves the float-value bytes here), so a budget that
    fires at raw fp32 size keeps buffering."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, (3, 40)).astype(np.int32)
    vals = rng.random((3, 40)).astype(np.float32)
    k20, v20 = keys[:, :20], vals[:, :20]
    budget = k20.nbytes + v20.nbytes  # the raw fp32 batch size
    raw = _engine(plane=plane, flush=FlushPolicy(max_elems=None,
                                                 max_bytes=budget))
    raw.ingest(k20, v20)
    assert raw.pending == 0  # raw bytes meet the budget: dispatched
    enc = _engine(plane=plane, flush=FlushPolicy(max_elems=None,
                                                 max_bytes=budget),
                  plane_opts={"codec": "size_adaptive"})
    enc.ingest(k20, v20)
    assert enc.pending == 20  # the encoded payload sits under the budget
    # int32 keys travel raw (dtype guard); small float values go fp16
    assert enc.plane.pending_bytes == k20.nbytes + v20.nbytes // 2
    enc.ingest(keys[:, 20:40], vals[:, 20:40])  # crosses -> flush
    assert enc.pending == 0 and enc.plane.pending_bytes == 0
    for eng in (raw, enc):
        eng.plane.close()
