"""Port parity of the kernel layer.

On the CPU the wrappers take their plain versions (``repro_torch.kernels.
ref``); these are held against the JAX package's Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  The CUDA kernels
are held against the plain versions on the card in ``test_torch_gpu.py``.

Tolerances: the query reads one float and multiplies it by +-1, so it must
be bit for bit.  The scatter sums many transformed values per bucket; the
fused -log/pow may differ by a few ulps between math libraries and the
summation order differs, so it is held to the reference's scale-aware
bound, rtol 1e-4 and atol 1e-5 * max(1, max|want|)
(benchmarks/engine_throughput.py), and, cell by cell, to the float32
rounding bound of its own terms (``ref.scatter_tolerance``), which a wrong
bucket or sign of a light key exceeds even where the scale-aware bound is
loose.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels import ppswor_transform as jtransform
from repro.kernels.countsketch_query import (
    countsketch_estimate as jest, countsketch_estimate_batched as jest_b,
    countsketch_query_batched as jq)
from repro.kernels.countsketch_scatter import (
    countsketch_scatter_batched as jscatter)
from repro_torch.core import hashing
from repro_torch.kernels import build, ops, ref, tiling
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import countsketch_scatter as ts
from repro_torch.kernels import ppswor_transform as tt

RTOL = 1e-4


def _atol(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _within_cell_bound(got, want, keys, vals, rows, width, seeds, **opts):
    tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
        _t(keys), _t(vals), rows, width, _t(seeds), **opts)).numpy()
    assert (np.abs(got - want) <= tol).all()


def _streams(B, n, seed, hi=50_000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, (B, n)).astype(np.int32)
    vals = rng.normal(size=(B, n)).astype(np.float32)
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    tseeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    return keys, vals, seeds, tseeds


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.array(x))


SCATTER_CASES = {
    "ppswor_p1": dict(p=1.0),
    "priority": dict(p=1.0, scheme="priority"),
    "p_half": dict(p=0.5),
    "p_two": dict(p=2.0),
    "no_transform": dict(p=None),
    "padding_stream": dict(p=1.0, pad_stream=1),
    "zero_length": dict(p=1.0, lengths=[300, 0, 137, 1]),
}


@pytest.mark.parametrize("rows,width", [(5, 384), (6, 1000)])
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_plain_scatter_matches_pallas_interpret(case, rows, width):
    opts = dict(SCATTER_CASES[case])
    keys, vals, seeds, tseeds = _streams(4, 300, seed=rows + len(case))
    pad = opts.pop("pad_stream", None)
    if pad is not None:
        keys[pad] = -1
    keys[2, ::5] = -1  # scattered padding slots
    lengths = opts.pop("lengths", None)
    want = np.asarray(jscatter(
        jnp.asarray(keys), jnp.asarray(vals), rows, width,
        jnp.asarray(seeds), transform_seeds=jnp.asarray(tseeds),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32),
        interpret=True, **opts))
    got = ops.sketch_sparse_batch(
        _t(keys), _t(vals), rows, width, _t(seeds),
        transform_seeds=_t(tseeds),
        lengths=None if lengths is None else torch.tensor(lengths),
        **opts).numpy()
    assert got.shape == (4, rows, width)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(want))
    _within_cell_bound(got, want, keys, vals, rows, width, seeds,
                       transform_seeds=_t(tseeds),
                       lengths=None if lengths is None
                       else torch.tensor(lengths), **opts)
    if pad is not None:
        assert not got[pad].any()
    if lengths is not None:
        assert not got[1].any()


@pytest.mark.parametrize("n", [1, 7])
def test_plain_scatter_tiny_batches(n):
    keys, vals, seeds, tseeds = _streams(1, n, seed=n)
    want = np.asarray(jref.countsketch_scatter_batched_ref(
        jnp.asarray(keys), jnp.asarray(vals), 5, 384, jnp.asarray(seeds),
        p=1.0, transform_seeds=jnp.asarray(tseeds)))
    got = ref.countsketch_scatter_ref(_t(keys[0]), _t(vals[0]), 5, 384,
                                      int(seeds[0]), p=1.0,
                                      transform_seed=int(tseeds[0])).numpy()
    np.testing.assert_allclose(got, want[0], rtol=RTOL, atol=_atol(want))
    _within_cell_bound(got[None], want, keys, vals, 5, 384, seeds, p=1.0,
                       transform_seeds=_t(tseeds))


@pytest.mark.parametrize("rows,width,k", [(5, 384, 37), (6, 1000, 1),
                                          (6, 1000, 300)])
def test_plain_query_bitwise_equals_pallas_and_ref(rows, width, k):
    rng = np.random.default_rng(width + k)
    B = 3
    tables = rng.normal(size=(B, rows, width)).astype(np.float32)
    keys = rng.integers(-2**31, 2**31 - 1, (B, k)).astype(np.int32)
    keys[:, 0] = -1
    seeds = np.array([0, 2**31 + 7, 2**32 - 1], np.uint32)
    pallas = np.asarray(jq(jnp.asarray(tables), jnp.asarray(keys),
                           jnp.asarray(seeds), interpret=True))
    oracle = np.asarray(jref.countsketch_query_batched_ref(
        jnp.asarray(tables), jnp.asarray(keys), jnp.asarray(seeds)))
    got = ops.query_rows_batched(_t(tables), _t(keys), _t(seeds)).numpy()
    assert got.shape == (B, rows, k)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, oracle)
    single = ref.countsketch_query_ref(_t(tables[1]), _t(keys[1]),
                                       int(seeds[1])).numpy()
    assert np.array_equal(single, oracle[1])


def _special_tables(rng, B, rows, width, nonfinite):
    """Tables a third of whose cells hold +-0, +-3e38 (above FLT_MAX / 2, so
    a sum of two overflows) or a tied +-1, and with ``nonfinite`` also NaN
    and +-inf; the rest N(0, 1)."""
    pool = [0.0, -0.0, 3e38, -3e38, 1.0, 1.0, -1.0]
    if nonfinite:
        pool += [np.nan, np.inf, -np.inf]
    pool = np.array(pool, np.float32)
    t = rng.normal(size=(B, rows, width)).astype(np.float32)
    pick = pool[rng.integers(0, len(pool), t.shape)]
    return np.where(rng.random(t.shape) < 0.33, pick, t).astype(np.float32)


def _equal(got, want) -> bool:
    return got.shape == want.shape and np.array_equal(got, want,
                                                      equal_nan=True)


# rows and tables: N(0, 1), finite special values, and NaN/+-inf as well
ESTIMATE_CASES = [pytest.param(5, "normal", id="5"),
                  pytest.param(6, "normal", id="6")] + [
    pytest.param(r, kind, id=f"{r}-{kind}")
    for kind in ("normal", "special", "nonfinite")
    for r in (1, 2, 3, 4, 5, 6, 7) if kind != "normal" or r not in (5, 6)]


@pytest.mark.parametrize("rows,kind", ESTIMATE_CASES)
def test_estimate_batched_bitwise_with_even_rows(rows, kind):
    """The estimate has jnp.median semantics, equal under == (NaN equal
    to NaN): an even row count averages the two middle reads as (lo + hi) *
    0.5, two reads above FLT_MAX / 2 overflow, -inf and inf give NaN, and a
    NaN read makes the estimate NaN.  Held against the JAX package's
    estimates through the Pallas query (interpret mode) and its gather
    oracle.  Where a table holds NaN or an infinity, only the oracle: the
    Pallas query gathers by a one-hot contraction, whose 0 * inf is NaN for
    every key of the block (a property of the TPU's gather, not of the
    estimate)."""
    rng = np.random.default_rng(rows + len(kind))
    if kind == "normal":
        tables = rng.normal(size=(2, rows, 384)).astype(np.float32)
    else:
        tables = _special_tables(rng, 2, rows, 384, kind == "nonfinite")
    if kind == "special":
        tables[0, :, ::2] = 3e38  # key pairs of these overflow to inf
    keys = rng.integers(0, 10_000, (2, 64)).astype(np.int32)
    seeds = np.array([5, 2**31], np.uint32)
    jt, jk, js = jnp.asarray(tables), jnp.asarray(keys), jnp.asarray(seeds)
    want = np.asarray(jref.countsketch_estimate_batched_ref(jt, jk, js))
    want1 = np.asarray(jref.countsketch_estimate_ref(jt[1], jk[1], js[1]))
    got = ops.estimate_batched(_t(tables), _t(keys), _t(seeds)).numpy()
    got1 = ops.estimate(_t(tables[1]), _t(keys[1]), int(seeds[1])).numpy()
    assert _equal(got, want) and _equal(got1, want1)
    assert _equal(ref.countsketch_estimate_batched_ref(
        _t(tables), _t(keys), _t(seeds)).numpy(), want)
    assert _equal(ref.countsketch_estimate_ref(
        _t(tables[1]), _t(keys[1]), int(seeds[1])).numpy(), want1)
    if kind != "nonfinite":
        assert _equal(got, np.asarray(jest_b(jt, jk, js, interpret=True)))
        assert _equal(got1, np.asarray(jest(jt[1], jk[1], js[1],
                                            interpret=True)))
    if kind == "special":
        assert np.isinf(got[0]).any()  # the overflow reaches the estimate
    if kind == "nonfinite":
        assert np.isnan(got).any()


@pytest.mark.parametrize("p", [0.5, 1.0, 1.5, 2.0])
def test_transform_edge_key_matches_pallas(p):
    """Key 17691050 under transform seed 0 draws uniform01 == 1.0, so its
    r = -log 1 is -0.0 and its factor infinite: the plain transform gives
    the same infinity, sign included, as the JAX package's Pallas kernel
    (interpret mode), -inf * v at p = 1 and +inf * v at p = 0.5, 1.5, 2;
    the other keys agree within rtol 1e-5."""
    keys = np.array([17691050, 0, 1, 12345, -7, 2**31 - 1], np.int32)
    vals = np.array([1.5, -2.0, 0.25, 3.0, -1.0, 7.0], np.float32)
    want = np.asarray(jtransform.ppswor_transform(
        jnp.asarray(keys), jnp.asarray(vals), p, 0, interpret=True))
    got = ref.ppswor_transform_ref(_t(keys), _t(vals), p, 0).numpy()
    assert np.isinf(want[0]) and got[0] == want[0]
    assert got[0] == (-np.inf if p == 1.0 else np.inf)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=0)


def test_transform_variant_by_alignment():
    """The transform's vector variant needs every tensor on 16 bytes; a
    view that starts 4 bytes in takes the scalar one."""
    x = torch.zeros(64)
    k = torch.zeros(64, dtype=torch.int32)
    assert tt.variant(k, x) == ("vector" if x.data_ptr() % 16 == 0
                                and k.data_ptr() % 16 == 0 else "scalar")
    assert tt.variant(k[1:], x[1:]) == "scalar"
    assert tt.variant(k[4:], x[4:]) == tt.variant(k, x)
    assert tt.VECTOR_WIDTH == {torch.float32: 4, torch.bfloat16: 8}


def test_estimate_fuses_up_to_16_rows():
    """The estimate kernel serves 1 to 16 rows; more take the row read and
    the plain median, by shape."""
    assert [tq.fuses(r) for r in (0, 1, 7, 16, 17)] == [False, True, True,
                                                       True, False]


def test_cpu_tensors_never_count_as_launches():
    counters = lambda: (ts.launches, dict(ts.variant_launches),  # noqa: E731
                        tq.launches, tq.estimate_launches,
                        tq.estimate_single_launches,
                        dict(tt.variant_launches))
    before = counters()
    keys, vals, seeds, tseeds = _streams(2, 50, seed=1)
    table = ops.sketch_sparse_batch(_t(keys), _t(vals), 5, 384, _t(seeds),
                                    p=1.0, transform_seeds=_t(tseeds))
    ops.estimate_batched(table, _t(keys), _t(seeds))
    ops.estimate(table[0], _t(keys[0]), int(seeds[0]))
    ops.transform(_t(keys[0]), _t(vals[0]), 1.0, 3)
    assert counters() == before


def test_wrappers_reject_other_devices():
    """A tensor that is on neither the CPU nor a card is refused, never
    routed to a plain version."""
    keys = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    vals = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        ts.countsketch_scatter_batched(keys, vals, 5, 384, 0, p=1.0)
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        tq.countsketch_query_batched(torch.zeros((2, 5, 384), device="meta"),
                                     keys, 0)
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        tq.countsketch_estimate_batched(
            torch.zeros((2, 5, 384), device="meta"), keys, 0)
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        tq.countsketch_estimate(torch.zeros((5, 384), device="meta"),
                                keys[0], 0)


def test_tiling_grid():
    assert tiling.grid_1d(1) == 1
    assert tiling.grid_1d(tiling.THREADS_PER_BLOCK) == 1
    assert tiling.grid_1d(tiling.THREADS_PER_BLOCK + 1) == 2
    assert tiling.grid_1d(4096 * 5120) == 4096 * 5120 // 256
    with pytest.raises(ValueError, match="grid limit"):
        tiling.grid_1d(2**31 * tiling.THREADS_PER_BLOCK)


def test_kernel_arguments_wrap_and_clamp():
    """Seeds go to a kernel as int32 with two's-complement wrap, from a
    scalar, an array or a tensor; lengths are clamped to [0, n]."""
    want = torch.tensor([-1, -2**31, 5], dtype=torch.int32)
    for seeds in ([2**32 - 1, 2**31, 5], np.array([2**32 - 1, 2**31, 5]),
                  torch.tensor([-1, 2**31, 5])):
        got = hashing.int32_arg(seeds, 3, "cpu")
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(hashing.int32_arg(2**32 - 7, 2, "cpu"),
                       torch.tensor([-7, -7], dtype=torch.int32))
    assert torch.equal(tiling.lengths_arg(None, 2, 9, "cpu"),
                       torch.tensor([9, 9], dtype=torch.int32))
    for lens in ([-3, 4, 2**31 + 5], torch.tensor([-3, 4, 2**31 + 5])):
        assert torch.equal(tiling.lengths_arg(lens, 3, 9, "cpu"),
                           torch.tensor([0, 4, 9], dtype=torch.int32))


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    """An edited source gets a new library name, so a stale build is never
    loaded; without a toolkit the build raises instead of falling back."""
    first = build._lib_path("countsketch_scatter")
    assert first.name.startswith("libcountsketch_scatter-")
    assert first.parent == build.BUILD_DIR
    src = tmp_path / "csrc"
    src.mkdir()
    for f in build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    assert build._lib_path("countsketch_scatter") == first
    (src / "hashing.cuh").write_text("// edited\n")
    assert build._lib_path("countsketch_scatter") != first
    assert build._lib_path("countsketch_query") != first
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_c_signatures_pass_pointers_as_void_p():
    """Every pointer and the stream go as c_void_p (a c_int would cut a
    64-bit device address)."""
    assert ts._ARGTYPES[:6] == [ctypes.c_void_p] * 6
    assert ts._ARGTYPES[-1] is ctypes.c_void_p
    assert ts._SMEM_ARGTYPES[:7] == [ctypes.c_void_p] * 7
    assert ts._SMEM_ARGTYPES[-1] is ctypes.c_void_p
    assert tq._ARGTYPES[:4] == [ctypes.c_void_p] * 4
    assert tq._ARGTYPES[-1] is ctypes.c_void_p


# one gemma2_2b decoder layer's 11 gradient leaves (chip_smoke.py LEAVES)
GEMMA_LAYER = [2304] * 4 + [2304 * 9216] * 3 + [2304 * 4 * 256] * 2 \
    + [8 * 256 * 2304] * 2
PLAN_CASES = {
    "sparse_cell": (4096, 5120, [5120] * 4096, 7, 2048),
    "gemma2_2b_layer": (11, max(GEMMA_LAYER), GEMMA_LAYER, 7, 2048),
    "one_segment_21M": (1, 2304 * 9216, [2304 * 9216], 7, 2048),
    "one_segment_1M": (1, 10**6, [10**6], 7, 2048),
    "ragged": (9, 200_000, [200_000, 77_123, 0, 1, 511, 512, 513,
                            199_999, 65_536], 7, 2048),
    "width_1984": (3, 50_000, [50_000, 0, 12_345], 5, 1984),
    "all_empty": (3, 100, [0, 0, 0], 7, 2048),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_table_plan_covers_every_live_slot_once(case):
    """The chunks of a shared-memory plan tile each stream's live slots
    [0, lengths[b]) exactly once; no block lies wholly past its stream's
    length, except the one block of an empty stream where each stream owns
    one block (it writes the stream's zeros); the grid is within its
    limits; the card-side block ends equal the host's."""
    B, n, lens, rows, width = PLAN_CASES[case]
    lens = np.asarray(lens, np.int64)
    plan = tiling.table_plan(B, n, lens, rows, width, 132)
    assert plan.variant == "smem" and plan.smem_bytes == rows * width * 4
    assert plan.smem_bytes <= tiling.SMEM_PER_BLOCK_OPTIN
    assert plan.threads == tiling.TABLE_THREADS <= 1024
    assert 0 < plan.blocks <= tiling.MAX_GRID_X
    assert plan.chunk > 0 and plan.chunk % plan.threads == 0
    blocks = tiling.plan_blocks(plan, lens)
    assert blocks.shape == (plan.blocks, 3)
    b, start, end = blocks.T
    covered = np.zeros(B, np.int64)
    order = np.lexsort((start, b))
    for s, e, stream in zip(start[order], end[order], b[order]):
        assert s == covered[stream]  # contiguous, no overlap, no gap
        covered[stream] = e
    assert np.array_equal(covered, lens)
    if plan.one_per_stream:
        assert np.array_equal(b, np.arange(B)) and not start.any()
    else:
        assert (end > start).all()
        assert (end - start <= plan.chunk).all()
        ends = tiling.block_ends(torch.from_numpy(lens).to(torch.int32),
                                 plan.chunk)
        assert ends.dtype == torch.int32
        assert ends.tolist() == tiling.block_ends(lens, plan.chunk).tolist()


@pytest.mark.parametrize("rows,width,fits", [
    (7, 2048, True), (5, 1000, True), (7, 8192, True), (7, 16384, False),
    (1, tiling.SMEM_PER_BLOCK_OPTIN // 4, True),
    (1, tiling.SMEM_PER_BLOCK_OPTIN // 4 + 1, False)])
def test_table_plan_variant_by_shape(rows, width, fits):
    """Shared memory exactly when the rows x width float32 table fits a
    block; a forced "smem" on a table that does not fit raises, a forced
    "global" is one thread per slot."""
    lens = np.array([300, 0])
    plan = tiling.table_plan(2, 300, lens, rows, width, 132)
    assert plan.variant == ("smem" if fits else "global")
    assert tiling.table_fits(rows, width) == fits
    glob = tiling.table_plan(2, 300, None, rows, width, 132,
                             variant="global")
    assert glob == (plan if not fits else glob)
    assert glob.variant == "global" and glob.blocks == tiling.grid_1d(600)
    assert glob.threads == tiling.THREADS_PER_BLOCK
    if not fits:
        with pytest.raises(ValueError, match="does not fit"):
            tiling.table_plan(2, 300, lens, rows, width, 132, variant="smem")
    with pytest.raises(ValueError, match="unknown kernel variant"):
        tiling.table_plan(2, 300, lens, rows, width, 132, variant="bogus")


def test_table_plan_deployment_shapes():
    """The sparse cell gets one block per stream; the gemma2_2b layer and
    one 21.2 M segment get many chunks of tens of thousands of slots, and
    the padded layer's dead slots get no block."""
    sparse = tiling.table_plan(*PLAN_CASES["sparse_cell"][:2],
                               np.full(4096, 5120), 7, 2048, 132)
    assert sparse.one_per_stream and sparse.blocks == 4096
    B, n, lens, rows, width = PLAN_CASES["gemma2_2b_layer"]
    layer = tiling.table_plan(B, n, np.array(lens), rows, width, 132)
    assert not layer.one_per_stream and 16_384 <= layer.chunk <= 262_144
    assert layer.blocks * layer.chunk < 1.1 * sum(lens) < 0.4 * B * n
    one = tiling.table_plan(1, lens[4], np.array([lens[4]]), 7, 2048, 132)
    assert not one.one_per_stream and one.blocks >= 132


def test_host_lengths_clamp_and_broadcast():
    assert tiling.host_lengths(None, 3, 9).tolist() == [9, 9, 9]
    assert tiling.host_lengths(4, 2, 9).tolist() == [4, 4]
    for lens in ([-3, 4, 2**31 + 5], torch.tensor([-3, 4, 2**31 + 5])):
        assert tiling.host_lengths(lens, 3, 9).tolist() == [0, 4, 9]
