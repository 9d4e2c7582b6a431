"""Port parity of the dense segment path and the single-stream kernel entry
points.

On the CPU the wrappers take their plain versions (``repro_torch.kernels.
ref``); these are held against the JAX package's Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  The CUDA kernels
are held against the plain versions on the card in ``test_torch_gpu.py``.

Tolerances: the dense update sums many transformed values per bucket, so it
is held to the scatter's bounds: rtol 1e-4 and atol 1e-5 * max(1, max|want|)
(benchmarks/engine_throughput.py), and, cell by cell, the float32 rounding
bound of its own terms (``ref.scatter_tolerance``).  The engine's tables use
the 1e-4 of tests/test_engine.py; candidate and sample keys are exact.  The
single-stream query and estimate read one float per row, so they are bit for
bit; the standalone transform and the single-segment sketch use the
tolerances of tests/test_kernels.py.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import engine as JE
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.countsketch_update import (
    countsketch_update_batched as jupdate)
from repro_torch import convert
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.engine import engine as tengine
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import countsketch_update as tu
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ppswor_transform as tt

RTOL = 1e-4


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.array(x))


def _atol(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _segments(B, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(B, n)).astype(np.float32)
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    tseeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    return vals, seeds, tseeds


# name -> kernel options; "base" and "lengths" are per-stream (B = 4)
UPDATE_CASES = {
    "ppswor_p1": dict(p=1.0),
    "priority": dict(p=1.0, scheme="priority"),
    "p_half": dict(p=0.5),
    "p_two": dict(p=2.0),
    "no_transform": dict(p=None),
    "ragged": dict(p=1.0, lengths=[300, 0, 137, 1]),
    "lengths_past_n": dict(p=1.0, lengths=[300, 301, 5000, 2**31 - 1]),
    # keys wrap past 2**31 and past 2**32; stream 3's key 0xFFFFFFFF is live
    "base_key_wrap": dict(p=1.0, base=[2**31 - 100, 2**32 - 5, 7,
                                       2**32 - 1]),
}


@pytest.mark.parametrize("rows,width", [(5, 384), (7, 512)])
@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_plain_update_matches_pallas_interpret(case, rows, width):
    opts = dict(UPDATE_CASES[case])
    vals, seeds, tseeds = _segments(4, 300, seed=rows + len(case))
    lengths = opts.pop("lengths", None)
    base = opts.pop("base", None)
    want = np.asarray(jupdate(
        jnp.asarray(vals), rows, width, jnp.asarray(seeds),
        transform_seeds=jnp.asarray(tseeds),
        base_keys=None if base is None else jnp.asarray(base, jnp.uint32),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32),
        interpret=True, **opts))
    kw = dict(transform_seeds=_t(tseeds),
              base_keys=None if base is None else torch.tensor(base),
              lengths=None if lengths is None else torch.tensor(lengths),
              **opts)
    got = ops.sketch_dense_batch(_t(vals), rows, width, _t(seeds),
                                 **kw).numpy()
    assert got.shape == (4, rows, width)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(want))
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        _t(vals), rows, width, _t(seeds), **kw)).numpy()
    assert (np.abs(got - want) <= tol).all()
    if lengths is not None and 0 in lengths:
        assert not got[lengths.index(0)].any()


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("case", ["ppswor_p1", "no_transform", "ragged",
                                  "base_key_wrap"])
def test_det_order_model_matches_pallas_interpret(case, chunk):
    """The deterministic dense update's order (``countsketch_update_det_
    ref``, the bits the card's det variant gives) is one more summation
    order of the same terms: within the kernel tolerance of the JAX kernel
    in interpret mode, and within each cell's rounding bound."""
    opts = dict(UPDATE_CASES[case])
    rows, width = 7, 512
    vals, seeds, tseeds = _segments(4, 300, seed=11 + len(case))
    lengths = opts.pop("lengths", None)
    base = opts.pop("base", None)
    want = np.asarray(jupdate(
        jnp.asarray(vals), rows, width, jnp.asarray(seeds),
        transform_seeds=jnp.asarray(tseeds),
        base_keys=None if base is None else jnp.asarray(base, jnp.uint32),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32),
        interpret=True, **opts))
    kw = dict(transform_seeds=_t(tseeds),
              base_keys=None if base is None else torch.tensor(base),
              lengths=None if lengths is None else torch.tensor(lengths),
              **opts)
    got = ref.countsketch_update_det_ref(_t(vals), rows, width, _t(seeds),
                                         chunk=chunk, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(want))
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        _t(vals), rows, width, _t(seeds), **kw)).numpy()
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("chunk", [32, 96, 256])
def test_det_order_model_is_the_det_scatters_chunk_by_chunk(chunk):
    """The dense order model is the det scatter's order model
    (``countsketch_scatter_det_ref``) on each chunk's dense keys, the chunk
    tables then summed in chunk order from 0.0: bit for bit.  Narrow rows
    make many cells collide within a 32-slot group."""
    rows, width, n = 3, 16, 300
    vals, seeds, _ = _segments(3, n, seed=chunk)
    base = np.array([5, 2**31 - 40, 1000], np.int64)
    lengths = np.array([300, 77, 0])
    got = ref.countsketch_update_det_ref(
        _t(vals), rows, width, _t(seeds), base_keys=torch.tensor(base),
        lengths=torch.tensor(lengths), chunk=chunk)
    keys = torch.from_numpy(((base[:, None] + np.arange(n)) % 2**32).astype(
        np.uint32).view(np.int32))
    want = torch.zeros((3, rows, width))
    for c0 in range(0, n, chunk):
        part = ref.countsketch_scatter_det_ref(
            keys[:, c0:c0 + chunk].contiguous(), _t(vals[:, c0:c0 + chunk]),
            rows, width, _t(seeds),
            lengths=torch.from_numpy(np.clip(lengths - c0, 0, chunk)))
        want = want + part
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[2].any()


def test_det_plan_cuts_the_dense_update_into_chunks():
    """Under the deterministic mode the dense update's plan is its own det
    block (a warp a row, the table and two stages of 896 transformed
    values) over chunks cut for 9 blocks an SM, each a multiple of the
    stage; at the gemma2_2b layer's 11 leaves (77.9 M live slots) that is
    1,183 blocks of 66,304 slots, and a segment that one chunk holds is one
    block that writes its delta row; a table too large for one block is
    spread over a thread block cluster, a CTA a row, its chunk still the
    whole table's."""
    from repro_torch.kernels import tiling

    d, ff = 2304, 9216
    lens = np.array([d] * 4 + [d * ff] * 2 + [d * 4 * 256, 8 * 256 * d,
                                              ff * d, d * 8 * 256,
                                              d * 4 * 256])
    plan = tiling.table_plan(11, int(lens.max()), lens, 7, 2048, 132,
                             deterministic=True, det_chunks=True)
    assert plan == tiling.TablePlan("det", 1183, 32 * 7, 66_304, False,
                                    64_512)
    assert plan.chunk % tiling.det_dense_stage(7) == 0
    assert plan.blocks == int(tiling.block_ends(lens, plan.chunk)[-1])
    small = tiling.table_plan(3, 600, np.array([500, 5, 0]), 7, 2048, 132,
                              deterministic=True, det_chunks=True)
    assert (small.variant, small.blocks, small.one_per_stream) == (
        "det", 3, True)
    wide = tiling.table_plan(2, 300, np.array([300, 3]), 7, 16384, 132,
                             deterministic=True, det_chunks=True)
    assert wide == tiling.TablePlan("det", 2 * 7, 32 * (8 + 1), 896, True,
                                    tiling.det_cluster_smem_bytes(
                                        7, 1, 16384, 16384), 1, 1, 7)


@pytest.mark.parametrize("rows,widest", [(1, 57_856), (5, 11_366),
                                         (7, 8_045), (8, 7_008)])
def test_det_dense_plan_threads_bytes_and_widest_table(rows, widest):
    """The dense det block's geometry (csrc/smem_table.cuh det_dense_block):
    32 x min(rows, 8) threads, a stage of 4 values a thread, the table and
    two stages of shared memory; the widest table one block holds fills
    the 232,448 B of a block, and one bucket more is spread over a
    thread block cluster (a CTA a row, or at rows 1 eight bucket ranges).
    One 21.2 M segment (#4) is 371 blocks of 57,344 slots (four tables'
    cells) at rows 7."""
    from repro_torch.kernels import tiling

    threads = 32 * min(rows, 8)
    assert tiling.det_dense_threads(rows) == threads
    assert tiling.det_dense_stage(rows) == 4 * threads
    assert tiling.det_dense_smem_bytes(rows, 2048) == (rows * 2048 * 4
                                                       + 8 * 4 * threads)
    lens = np.array([300_000, 5, 70_001])
    plan = tiling.table_plan(3, 300_000, lens, rows, widest, 132,
                             deterministic=True, det_chunks=True)
    assert (plan.variant, plan.threads, plan.smem_bytes) == (
        "det", threads, tiling.det_dense_smem_bytes(rows, widest))
    assert plan.smem_bytes <= tiling.SMEM_PER_BLOCK_OPTIN \
        < tiling.det_dense_smem_bytes(rows, widest + 1)
    assert plan.chunk % (4 * threads) == 0 and plan.chunk % 32 == 0
    assert (plan.row_group, plan.ranges) == (0, 1)
    split = tiling.table_plan(3, 300_000, lens, rows, widest + 1, 132,
                              deterministic=True, det_chunks=True)
    group, ranges = tiling.det_cluster(rows, widest + 1)
    assert (split.row_group, split.ranges) == (group, ranges) != (0, 1)
    assert split.cluster == tiling.det_parts(split, rows) == (
        8 if rows == 1 else rows)
    assert split.chunk == tiling.table_plan(
        3, 300_000, lens, rows, widest + 1, 132, "det", det_chunks=True,
        deterministic=True).chunk
    assert split.smem_bytes <= tiling.SMEM_PER_BLOCK_OPTIN
    assert split.blocks == plan.blocks * tiling.det_parts(split, rows)
    if rows == 7:
        one = tiling.table_plan(1, 2304 * 9216, np.array([2304 * 9216]), 7,
                                2048, 132, deterministic=True,
                                det_chunks=True)
        assert one == tiling.TablePlan("det", 371, 224, 57_344, False,
                                       64_512)


def test_plain_update_sketches_key_0xffffffff():
    """Dense keys are masked by length only: the live key 0xFFFFFFFF (int32
    -1, the scatter's padding key) is sketched, in the port as in JAX."""
    vals, seeds, tseeds = _segments(1, 8, seed=3)
    base = 2**32 - 5            # slot 4 holds key 0xFFFFFFFF
    cut = vals.copy()
    cut[0, 4] = 0.0
    tables = []
    for v in (vals, cut):
        got = ref.countsketch_update_ref(_t(v[0]), base, 5, 384,
                                         int(seeds[0]), p=1.0,
                                         transform_seed=int(tseeds[0]))
        want = np.asarray(jref.countsketch_update_ref(
            jnp.asarray(v[0]), base, 5, 384, jnp.uint32(seeds[0]), p=1.0,
            transform_seed=jnp.uint32(tseeds[0])))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=_atol(want))
        tables.append(got)
    assert (tables[0] != tables[1]).sum() == 5   # one cell a row


def _jax_leaves(st):
    return (np.asarray(st.sketch.table), np.asarray(st.sketch.seed),
            np.asarray(st.cand_keys), np.asarray(st.seed_transform))


@pytest.mark.parametrize("p,scheme,base,lengths", [
    (1.0, "ppswor", None, None),
    (0.5, "priority", None, [700, 123, 0]),
    (2.0, "ppswor", [2**31 - 300, 2**32 - 100, 9], [700, 5000, 400]),
])
def test_onepass_update_dense_matches_reference(p, scheme, base, lengths):
    """Two dense steps through the port's onepass_update_dense (plain
    versions on the CPU) and JAX's (Pallas in interpret mode): allclose
    tables, identical candidate buffers and sample keys."""
    jcfg = JE.EngineConfig(num_streams=3, rows=5, width=384, candidates=32,
                           p=p, scheme=scheme)
    jst = JE.onepass_init_batched(jcfg)
    tst = convert.onepass_state_from_numpy(*_jax_leaves(jst), device="cpu")
    rng = np.random.default_rng(int(p * 10))
    jb = None if base is None else jnp.asarray(base, jnp.uint32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    for _ in range(2):
        vals = (rng.normal(size=(3, 700))
                * np.exp(rng.normal(size=(3, 700)))).astype(np.float32)
        jst = JE.onepass_update_dense(jst, jnp.asarray(vals), p,
                                      base_keys=jb, lengths=jl,
                                      scheme=scheme, interpret=True)
        tst = tengine.onepass_update_dense(
            tst, _t(vals), p,
            base_keys=None if base is None else torch.tensor(base),
            lengths=None if lengths is None else torch.tensor(lengths),
            scheme=scheme)
    want = _jax_leaves(jst)
    np.testing.assert_allclose(tst.sketch.table.numpy(), want[0], rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(tst.cand_keys.numpy(), want[2])
    js = JE.onepass_sample_batched(jst, 8, p, scheme)
    ts = tengine.onepass_sample_batched(tst, 8, p, scheme)
    assert np.array_equal(ts.keys.numpy(), np.asarray(js.keys))


def test_engine_update_dense_matches_reference_engine():
    cfg = dict(num_streams=3, rows=5, width=384, candidates=32)
    je = JE.SketchEngine(JE.EngineConfig(**cfg))
    te = SketchEngine(EngineConfig(**cfg), device="cpu")
    vals = np.random.default_rng(4).normal(size=(3, 500)).astype(np.float32)
    je.update_dense(jnp.asarray(vals), base_keys=jnp.asarray([0, 10, 2**31],
                                                             jnp.uint32),
                    lengths=jnp.asarray([500, 250, 499], jnp.int32))
    te.update_dense(vals, base_keys=[0, 10, 2**31], lengths=[500, 250, 499])
    np.testing.assert_allclose(te.state.sketch.table.numpy(),
                               np.asarray(je.state.sketch.table), rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(te.state.cand_keys.numpy(),
                          np.asarray(je.state.cand_keys))
    assert np.array_equal(te.sample(8).keys.numpy(),
                          np.asarray(je.sample(8).keys))


def test_update_dense_drains_buffer_first():
    cfg = EngineConfig(num_streams=3, rows=5, width=384, candidates=32)
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 40, (3, 30)).astype(np.int32)
    vals = rng.normal(size=(3, 30)).astype(np.float32)
    dense = np.abs(rng.normal(size=(3, 40))).astype(np.float32)
    eng = SketchEngine(cfg, flush_elems=10_000, device="cpu")
    eng.ingest(keys, vals)
    eng.update_dense(dense)
    assert eng.pending == 0
    want = SketchEngine(cfg, device="cpu")
    want.ingest(keys, vals)
    want.flush()
    want.update_dense(dense)
    for a, b in zip(tengine._leaves(eng.state), tengine._leaves(want.state)):
        assert torch.equal(a, b)


def test_update_dense_rejects_other_samplers():
    eng = SketchEngine(EngineConfig(num_streams=2, rows=5, width=384,
                                    candidates=16), device="cpu")
    eng.cfg = eng.cfg._replace(sampler="twopass")
    with pytest.raises(ValueError, match="only 'onepass'"):
        eng.update_dense(np.zeros((2, 8), np.float32))


@pytest.mark.parametrize("n,width,base", [(1, 256, 0), (1000, 777, 12345),
                                          (3000, 512, 2**32 - 1000)])
def test_sketch_dense_vector_matches_pallas(n, width, base):
    vals = np.random.default_rng(n).normal(size=n).astype(np.float32)
    for p in (None, 1.0):
        want = np.asarray(jops.sketch_dense_vector(
            jnp.asarray(vals), 5, width, seed=9, p=p, transform_seed=11,
            base_key=jnp.uint32(base), interpret=True))
        got = ops.sketch_dense_vector(_t(vals), 5, width, seed=9, p=p,
                                      transform_seed=11,
                                      base_key=base).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3 if p else 2e-5,
                                   atol=1e-3 if p else 2e-5)


def test_sketch_dense_vector_bfloat16_is_cast():
    vals = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    jv = jnp.asarray(vals).astype(jnp.bfloat16)
    want = np.asarray(jops.sketch_dense_vector(jv, 3, 512, seed=3,
                                               interpret=True))
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ops.sketch_dense_vector(tv, 3, 512, seed=3).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-2)


def test_sketch_sparse_vector_matches_pallas():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 5000, 400).astype(np.int32)
    keys[::7] = -1
    vals = rng.normal(size=400).astype(np.float32)
    want = np.asarray(jops.sketch_sparse_vector(
        jnp.asarray(keys), jnp.asarray(vals), 5, 384, 2**31 + 3, p=1.0,
        transform_seed=17, interpret=True))
    got = ops.sketch_sparse_vector(_t(keys), _t(vals), 5, 384, 2**31 + 3,
                                   p=1.0, transform_seed=17).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(want))


@pytest.mark.parametrize("rows,width,k", [(5, 777, 37), (7, 2048, 512),
                                          (6, 256, 1)])
def test_query_rows_and_estimate_bitwise(rows, width, k):
    rng = np.random.default_rng(k)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    keys = rng.integers(-2**31, 2**31 - 1, k).astype(np.int32)
    keys[0] = -1
    seed = 2**32 - 7
    want = np.asarray(jops.query_rows(jnp.asarray(table), jnp.asarray(keys),
                                      jnp.uint32(seed), interpret=True))
    got = ops.query_rows(_t(table), _t(keys), seed).numpy()
    assert got.shape == (rows, k) and np.array_equal(got, want)
    want_est = np.asarray(jops.estimate(jnp.asarray(table),
                                        jnp.asarray(keys), jnp.uint32(seed),
                                        interpret=True))
    got_est = ops.estimate(_t(table), _t(keys), seed).numpy()
    assert np.array_equal(got_est, want_est)
    assert np.array_equal(
        ref.countsketch_estimate_ref(_t(table), _t(keys), seed).numpy(),
        np.asarray(jref.countsketch_estimate_ref(
            jnp.asarray(table), jnp.asarray(keys), jnp.uint32(seed))))


@pytest.mark.parametrize("n", [1, 4096, 9999])
@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
def test_transform_float32_matches_pallas(n, p):
    rng = np.random.default_rng(n)
    keys = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jops.transform(jnp.asarray(keys), jnp.asarray(vals), p,
                                     12, interpret=True))
    got = ops.transform(_t(keys), _t(vals), p, 12)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_transform_bfloat16_matches_pallas():
    keys = np.arange(512, dtype=np.int32)
    vals = np.random.default_rng(0).normal(size=512).astype(np.float32)
    jv = jnp.asarray(vals).astype(jnp.bfloat16)
    want = np.asarray(jops.transform(jnp.asarray(keys), jv, 1.0, 5,
                                     interpret=True), np.float32)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ops.transform(_t(keys), tv, 1.0, 5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2e-2, atol=1e-2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.transform(_t(keys), tv.to(torch.float16), 1.0, 5)


def test_cpu_tensors_never_count_as_launches():
    counters = lambda: (tu.launches, tu.single_launches,  # noqa: E731
                        dict(tu.variant_launches), tq.single_launches,
                        tt.launches)
    before = counters()
    vals, seeds, tseeds = _segments(2, 50, seed=1)
    ops.sketch_dense_batch(_t(vals), 5, 384, _t(seeds), p=1.0,
                           transform_seeds=_t(tseeds))
    table = ops.sketch_dense_vector(_t(vals[0]), 5, 384, 3)
    keys = torch.arange(20, dtype=torch.int32)
    ops.query_rows(table, keys, 3)
    ops.estimate(table, keys, 3)
    ops.transform(keys, torch.ones(20), 1.0, 3)
    assert counters() == before


def test_wrappers_reject_other_devices():
    """A tensor that is on neither the CPU nor a card is refused, never
    routed to a plain version."""
    vals = torch.zeros((2, 4), device="meta")
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    for call in (lambda: tu.countsketch_update_batched(vals, 5, 384, 0),
                 lambda: tu.countsketch_update(vals[0], 5, 384, 0),
                 lambda: tq.countsketch_query(
                     torch.zeros((5, 384), device="meta"), keys, 0),
                 lambda: tt.ppswor_transform(keys, vals[0], 1.0, 0)):
        with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
            call()


def test_c_signatures_pass_pointers_as_void_p():
    assert tu._ARGTYPES[:6] == [ctypes.c_void_p] * 6
    assert tu._ARGTYPES[-1] is ctypes.c_void_p
    assert tu._SMEM_ARGTYPES[:7] == [ctypes.c_void_p] * 7
    assert tu._SMEM_ARGTYPES[-1] is ctypes.c_void_p
    assert tu._DET_ARGTYPES[:8] == [ctypes.c_void_p] * 8
    assert tu._DET_ARGTYPES[-1] is ctypes.c_void_p
    assert len(tu._DET_ARGTYPES) == 22
    assert tt._ARGTYPES[:3] == [ctypes.c_void_p] * 3
    assert tt._ARGTYPES[-1] is ctypes.c_void_p
