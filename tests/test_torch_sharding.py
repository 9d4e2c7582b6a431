"""The port's merge trees (``repro_torch.distributed.sharding``) against the
JAX package's host forms, and its collective form over ``torch.distributed``
(gloo), on the CPU.

* ``merge_states``, ``tree_merge`` and the host butterfly give the
  reference's states bit for bit, for 2 to 5 shards (the shard states are
  carried across by ``convert.py``, so both packages merge the same bits).
* The seed guards raise under a lossy codec too; a lossy ``merge_states``
  equals the merge of the roundtripped states; ``none`` is bitwise the
  default; the reference's error messages.
* The collective butterfly and ``psum_sketch`` run over gloo at 2 and 4
  ranks, and the ``all_gather`` + tree fallback at 3.  Each rank's state
  equals the host form's entry for that rank bit for bit.  The ranks are
  spawned with ``torch.multiprocessing``, meet through a ``FileStore``
  (no port), and each test has its own time limit.
"""
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import engine as JE
from repro.distributed import sharding as jshd
from repro.engine import planes as JP
from repro_torch import convert
from repro_torch.core import countsketch
from repro_torch.distributed import codecs as C
from repro_torch.distributed import pytree
from repro_torch.distributed import sharding as shd
from repro_torch.engine import EngineConfig, SketchEngine

jax.config.update("jax_platform_name", "cpu")

GLOO_TIMEOUT_S = 180.0  # each gloo test's own limit, spawn included


def _cfg(seed=7, **kw):
    base = dict(num_streams=3, rows=3, width=128, candidates=16,
                capacity=16, p=1.0, seed=seed, sampler="onepass", domain=40,
                num_samplers=8)
    base.update(kw)
    return base


def _batches(nb, seed, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 40, (3, n)).astype(np.int32),
             rng.integers(1, 4, (3, n)).astype(np.float32))
            for _ in range(nb)]


def _shard_states(shards, name="onepass", seeds=None):
    """Per-shard JAX states of one partitioned stream, the port's copies of
    them, and a port engine (for its batched merge)."""
    seeds = seeds or [7] * shards
    jengs = [JE.SketchEngine(JE.EngineConfig(**_cfg(s, sampler=name)),
                             flush_elems=1) for s in seeds]
    for k, v in _batches(5, seed=11):
        for eng, (bk, bv) in zip(jengs, JP.partition_by_key(k, v, shards)):
            if bk.shape[1]:
                eng.ingest(bk, bv)
    jstates = [e.state for e in jengs]
    eng = SketchEngine(EngineConfig(**_cfg(sampler=name)), device="cpu")
    states = [convert.state_from_numpy(
        type(eng.state), [np.asarray(x) for x in
                          jax.tree_util.tree_leaves(st)], "cpu")
        for st in jstates]
    return jengs, jstates, eng, states


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


def _assert_matches_jax(st, jst):
    got = convert.state_to_numpy(st)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


def _assert_port_equal(a, b):
    for x, y in zip(pytree.leaves(a), pytree.leaves(b)):
        assert _bits(C.to_host(x)) == _bits(C.to_host(y))


# ---------------------------------------------------------------------------
# host forms against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3, 4, 5])
@pytest.mark.parametrize("name", ["onepass", "twopass"])
def test_host_forms_match_reference_bitwise(name, shards):
    jengs, jstates, eng, states = _shard_states(shards, name)
    jmerge = jengs[0].ops.merge
    _assert_matches_jax(shd.merge_states(states, eng.merge_fn),
                        jshd.merge_states(jstates, jmerge))
    _assert_matches_jax(shd.tree_merge(states, eng.merge_fn),
                        jshd.tree_merge(jstates, jmerge))
    if shards & (shards - 1) == 0:
        _assert_matches_jax(shd.butterfly_allmerge(states, None,
                                                   eng.merge_fn),
                            jshd.butterfly_allmerge(jstates, None, jmerge))


@pytest.mark.parametrize("shards", [2, 3, 4, 5])
def test_merge_states_equals_tree_merge_bitwise(shards):
    _, _, eng, states = _shard_states(shards)
    _assert_port_equal(shd.merge_states(states, eng.merge_fn),
                       shd.tree_merge(states, eng.merge_fn))


def test_spec_and_empty_and_single():
    _, _, eng, states = _shard_states(2)
    _assert_port_equal(shd.merge_states(states, eng.spec),
                       shd.merge_states(states, eng.spec.merge))
    with pytest.raises(ValueError, match="no states"):
        shd.merge_states([], lambda a, b: a)
    with pytest.raises(ValueError, match="no states"):
        shd.tree_merge([], lambda a, b: a)
    with pytest.raises(TypeError, match="merge callable"):
        shd.tree_merge(states, object())
    assert shd.merge_states(states[:1], eng.merge_fn) is states[0]


@pytest.mark.parametrize("codec", ["none", "q8"])
@pytest.mark.parametrize("shards", [2, 3])
def test_seed_mismatch_rejected(shards, codec):
    """A shard hashed under another seed is not a shard of the same
    logical stream: both branches raise, under a lossy codec too (seeds
    travel raw)."""
    _, _, eng, states = _shard_states(shards, seeds=[7] * (shards - 1) + [8])
    with pytest.raises(ValueError, match="seeds"):
        shd.merge_states(states, eng.merge_fn, codec=codec)
    with pytest.raises(ValueError, match="seeds"):
        shd.tree_merge(states, eng.merge_fn, codec=codec)


def test_butterfly_host_form_seed_guard_and_ragged():
    _, _, eng, states = _shard_states(4, seeds=[7, 7, 8, 7])
    with pytest.raises(ValueError, match="butterfly_allmerge.*seeds"):
        shd.butterfly_allmerge(states, None, eng.merge_fn)
    _, _, eng, states = _shard_states(3)
    with pytest.raises(ValueError, match="power-of-two"):
        shd.butterfly_allmerge(states, None, eng.merge_fn)
    with pytest.raises(ValueError, match="no states"):
        shd.butterfly_allmerge([], None, eng.merge_fn)


@pytest.mark.parametrize("codec", ["fp16", "q8", "size_adaptive"])
@pytest.mark.parametrize("shards", [2, 3])
def test_lossy_merge_equals_merge_of_roundtripped(shards, codec):
    _, jstates, eng, states = _shard_states(shards)
    cdc = C.get_codec(codec)
    got = shd.merge_states(states, eng.merge_fn, codec=cdc)
    want = shd.merge_states([cdc.roundtrip(s) for s in states], eng.merge_fn)
    _assert_port_equal(got, want)
    _assert_port_equal(shd.merge_states(states, eng.merge_fn, codec="none"),
                       shd.merge_states(states, eng.merge_fn))
    jmerge = JE.SketchEngine(JE.EngineConfig(**_cfg())).ops.merge
    _assert_matches_jax(got, jshd.merge_states(jstates, jmerge, codec=codec))


def test_collective_form_refuses_lossy_codec_and_no_group():
    _, _, eng, states = _shard_states(2)
    with pytest.raises(ValueError, match="lossy codec"):
        shd.butterfly_allmerge(states[0], None, eng.merge_fn, codec="q8")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        shd.butterfly_allmerge(states[0], None, eng.merge_fn)
    with pytest.raises(RuntimeError, match="process group"):
        shd.psum_sketch(states[0].sketch)


# ---------------------------------------------------------------------------
# the collective form over gloo
# ---------------------------------------------------------------------------

def _rank_inputs(rank, world):
    """Rank ``rank``'s shard of one stream (a port state on the CPU), and a
    CountSketch of integer-valued updates (exact sums in any order)."""
    eng = SketchEngine(EngineConfig(**_cfg()), flush_elems=1, device="cpu")
    from repro_torch.engine import planes

    for k, v in _batches(5, seed=11):
        bk, bv = planes.partition_by_key(k, v, world)[rank]
        if bk.shape[1]:
            eng.ingest(bk, bv)
    g = torch.Generator().manual_seed(rank)
    sk = countsketch.update(
        countsketch.init(3, 64, torch.tensor(9)),
        torch.randint(0, 500, (40,), generator=g, dtype=torch.int32),
        torch.randint(-3, 4, (40,), generator=g).to(torch.float32))
    return eng, sk


def _gloo_rank(rank, world, store_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        eng, sk = _rank_inputs(rank, world)
        merged = shd.butterfly_allmerge(eng.state, None, eng.merge_fn)
        summed = shd.psum_sketch(sk)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 *convert.state_to_numpy(merged),
                 *convert.state_to_numpy(summed))
    finally:
        dist.destroy_process_group()


def _run_gloo(tmp_path, world):
    ctx = mp.start_processes(_gloo_rank, args=(world, str(tmp_path / "store"),
                                               str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"gloo ranks ({world}) did not finish "
                                     f"within {GLOO_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10.0)
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            out.append([z[f"arr_{i}"] for i in range(len(z.files))])
    return out


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gloo_butterfly_and_psum_equal_host_forms(tmp_path, world):
    """Every rank ends with the host form's entry for it: the XOR rounds'
    entry at 2 and 4 ranks, the tree over all shards at 3 (the fallback);
    ``psum_sketch`` gives every rank the summed table."""
    got = _run_gloo(tmp_path, world)
    inputs = [_rank_inputs(r, world) for r in range(world)]
    merge = inputs[0][0].merge_fn
    states = [eng.state for eng, _ in inputs]
    if world & (world - 1) == 0:
        want = shd.butterfly_rounds(states, merge)
    else:
        want = [shd.tree_merge(states, merge)] * world
    table = sum(sk.table for _, sk in inputs)
    for r in range(world):
        expect = convert.state_to_numpy(want[r]) + [table.numpy(),
                                                    np.uint32(9)]
        assert len(got[r]) == len(expect)
        for g, w in zip(got[r], expect):
            assert _bits(g) == _bits(np.asarray(w)), (world, r)
