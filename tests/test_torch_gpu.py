"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips, inside its body, when no card
is present: a CUDA kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the query reads one float and multiplies it by +-1, so it must
be bit for bit; the estimate, whose median of rows is
``countsketch.median``'s arithmetic, must equal it under ``==`` with NaN
equal to NaN (a tie of -0 and +0 may pick either).  The scatter and the
dense update sum many transformed values per bucket with float atomics,
whose order varies from run to run, and their fused -log/pow may differ
from PyTorch's by a few ulps, so they are held to the reference's
scale-aware bound, rtol 1e-4 and atol 1e-5 * max(1, max|want|), and, cell
by cell, to the float32 rounding bound of their own terms
(``ref.scatter_tolerance``).  The standalone transform is held to the
tolerances of tests/test_kernels.py: rtol 1e-5 / atol 1e-6 in float32,
rtol 2e-2 / atol 1e-2 in bfloat16 (one rounding of the factor may flip),
with the plain version's infinities (the uniform01 == 1.0 edge) equal,
signs included.

The scatter and the dense update have two variants, chosen by shape
(``tiling.table_plan``): a shared-memory table per block, and global
atomics for tables too large for shared memory.  The cells run both,
through the wrappers' private ``_variant`` keyword where the shape alone
would pick the other, and check which one each launch took by its
``variant_launches`` counter.  The transform's scalar variant is reached
through views that start one element in, which its alignment rule sends
there.

Under ``torch.use_deterministic_algorithms(True)`` the scatter takes its
"det" variant, which sums every cell in an order fixed by slot index: its
launches must give the same bits, and its cells stay within the plain
version's bound.  PyTorch's ``scatter_add_`` and ``index_add_`` on the
flush's shapes, and the async plane against the sparse plane, must then
give the same bits too.  So must the dense update's "det" variant (each
chunk of a segment summed in slot order, the chunks in chunk order),
whose bits are its order model's, ``ref.countsketch_update_det_ref``.

The model families run reduced on the card in float32 with TF32 off:
decode against the teacher-forced forward (the reference test's 0.1 of
max|logit|), and the card's forward, prefill and decode steps against the
CPU's; the reduced mamba2's prefill in the deterministic mode; the serving
CLI of each decoder family with its analytics' kernel launches.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from repro_torch.core import countsketch, hashing, worp
from repro_torch.core.sampler import SamplerConfig, make_sampler
from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.engine.engine import _leaves
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import countsketch_scatter as ts
from repro_torch.kernels import countsketch_update as tu
from repro_torch.kernels import ppswor_transform as tt
from repro_torch.kernels import ref, tiling
from repro_torch.kernels import segment_sum as tseg

pytestmark = pytest.mark.gpu

RTOL = 1e-4
SCATTER_CASES = {
    "ppswor_p1": dict(p=1.0),
    "priority": dict(p=1.0, scheme="priority"),
    "p_half": dict(p=0.5),
    "p_two": dict(p=2.0),
    "no_transform": dict(p=None),
    "padding_stream": dict(p=1.0, pad_stream=1),
    "zero_length": dict(p=1.0, lengths=[300, 0, 137, 1]),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _atol(want: torch.Tensor) -> float:
    return 1e-5 * max(1.0, float(want.abs().max()))


def _streams(B, n, seed, hi=50_000):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, hi, (B, n)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.int64))
    tseeds = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.int64))
    return keys, vals, seeds, tseeds


def _check_sum(got, want, count_mass):
    """Both bounds of a summing kernel: the scale-aware allclose and each
    cell's float32 rounding bound."""
    torch.testing.assert_close(got, want, rtol=RTOL, atol=_atol(want))
    assert bool(((got - want).abs() <= ref.scatter_tolerance(
        *count_mass)).all())


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_cuda_scatter_matches_plain(case, variant):
    _need_card()
    opts = dict(SCATTER_CASES[case])
    keys, vals, seeds, tseeds = _streams(4, 300, seed=3)
    pad = opts.pop("pad_stream", None)
    if pad is not None:
        keys[pad] = -1
    lengths = opts.pop("lengths", None)
    lengths = None if lengths is None else torch.tensor(lengths)
    want = ref.countsketch_scatter_batched_ref(
        keys, vals, 6, 1000, seeds, transform_seeds=tseeds, lengths=lengths,
        **opts)
    before = (ts.launches, ts.variant_launches[variant])
    got = ts.countsketch_scatter_batched(
        keys.cuda(), vals.cuda(), 6, 1000, seeds.cuda(),
        transform_seeds=tseeds.cuda(),
        lengths=None if lengths is None else lengths.cuda(), **opts,
        _variant=variant).cpu()
    assert (ts.launches, ts.variant_launches[variant]) == (before[0] + 1,
                                                           before[1] + 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=_atol(want))
    tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
        keys, vals, 6, 1000, seeds, transform_seeds=tseeds, lengths=lengths,
        **opts))
    assert bool(((got - want).abs() <= tol).all())
    if pad is not None:
        assert not got[pad].any()
    if lengths is not None:
        assert not got[1].any()


@pytest.mark.parametrize("variant", ["smem", "global", None])
def test_cuda_single_stream_scatter_counts_its_launches(variant):
    """``countsketch_scatter`` (one stream, a B = 1 launch of #1) against
    its plain version: the shared-memory and global variants within the
    scatter's bounds, each counted in ``single_launches`` and not in the
    batched ``launches``; in the deterministic mode (``variant`` None) the
    det variant, the same bits as its order model."""
    _need_card()
    keys, vals, seeds, tseeds = _streams(1, 5000, seed=8, hi=700)
    keys[0, ::7] = -1
    k, v = keys[0], vals[0]
    seed, tseed = int(seeds[0]), int(tseeds[0])
    label = variant or "det"
    before = (ts.launches, ts.single_launches, ts.variant_launches[label])
    with _deterministic() if variant is None else contextlib.nullcontext():
        got = ts.countsketch_scatter(k.cuda(), v.cuda(), 6, 1000, seed,
                                     p=None if variant is None else 1.0,
                                     transform_seed=tseed,
                                     _variant=variant).cpu()
    assert (ts.launches, ts.single_launches, ts.variant_launches[label]) == (
        before[0], before[1] + 1, before[2] + 1)
    assert got.shape == (6, 1000)
    if variant is None:
        want = ref.countsketch_scatter_det_ref(keys, vals, 6, 1000,
                                               seeds[:1])[0]
        assert _same_bits(got, want)
        return
    want = ref.countsketch_scatter_ref(k, v, 6, 1000, seed, p=1.0,
                                       transform_seed=tseed)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=_atol(want))
    tol = ref.scatter_tolerance(*ref.countsketch_scatter_mass_ref(
        keys, vals, 6, 1000, seeds[:1], p=1.0, transform_seeds=tseeds[:1]))
    assert bool(((got - want).abs() <= tol[0]).all())


@pytest.mark.parametrize("B,rows,k", [(2, 7, 512), (1, 7, 512),
                                     (4096, 7, 512), (4096, 17, 512)])
def test_cuda_row_read_at_timed_shapes_bitwise(B, rows, k):
    """The row read (a thread a (stream, row, key) read) at the shapes
    ``chip_smoke.py`` times it: ``query_rows_batched``'s B = 2, k = 512,
    one table (``countsketch_query``, #5), and the flush's B = 4096 x 512
    candidates at rows 7 and at 17 (the estimate's fallback): bit for bit
    the plain version's, one launch each."""
    _need_card()
    g = torch.Generator().manual_seed(B + rows)
    tables = torch.randn((B, rows, 2048), generator=g).cuda()
    keys = torch.randint(-2**31, 2**31 - 1, (B, k), generator=g,
                         dtype=torch.int64).to(torch.int32).cuda()
    seeds = torch.randint(0, 2**32, (B,), generator=g).cuda()
    want = ref.countsketch_query_batched_ref(tables, keys, seeds)
    before = (tq.launches, tq.single_launches)
    if B == 1:
        got = tq.countsketch_query(tables[0], keys[0], seeds[0])[None]
        assert (tq.launches, tq.single_launches) == (before[0],
                                                     before[1] + 1)
    else:
        got = tq.countsketch_query_batched(tables, keys, seeds)
        assert (tq.launches, tq.single_launches) == (before[0] + 1,
                                                     before[1])
    assert _same_bits(got, want)
    if not tq.fuses(rows):
        assert _same_bits(tq.countsketch_estimate_batched(tables, keys,
                                                          seeds),
                          countsketch.median(want, 1))


@pytest.mark.parametrize("rows,width,k", [(5, 384, 37), (7, 2048, 1),
                                          (6, 1000, 5632)])
def test_cuda_query_bitwise_equals_plain(rows, width, k):
    _need_card()
    rng = np.random.default_rng(k)
    tables = torch.from_numpy(
        rng.normal(size=(3, rows, width)).astype(np.float32))
    keys = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (3, k)).astype(np.int32))
    keys[:, 0] = -1
    seeds = torch.tensor([0, 2**31 + 7, 2**32 - 1])
    want = ref.countsketch_query_batched_ref(tables, keys, seeds)
    before = tq.launches
    got = tq.countsketch_query_batched(tables.cuda(), keys.cuda(),
                                       seeds.cuda()).cpu()
    assert tq.launches == before + 1
    assert torch.equal(got, want)


def _special_tables(rng, B, rows, width):
    """Tables a third of whose cells hold NaN, +-inf, +-0, +-3e38 (two of
    which overflow in a sum) or a tied +-1."""
    pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 3e38, -3e38, 1.0,
                     1.0, -1.0], np.float32)
    t = rng.normal(size=(B, rows, width)).astype(np.float32)
    pick = pool[rng.integers(0, len(pool), t.shape)]
    return torch.from_numpy(np.where(rng.random(t.shape) < 0.33, pick, t))


def _same(got, want) -> bool:
    return got.shape == want.shape and bool(
        ((got == want) | (got.isnan() & want.isnan())).all())


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 16, 17])
def test_cuda_estimate_bitwise_equals_plain(rows):
    """The estimate kernel against countsketch.median of the plain reads,
    bit for bit, batched and B = 1, on special values and at k not a
    multiple of a block; 17 rows take the row read and the plain median,
    each launch on its own counter."""
    _need_card()
    rng = np.random.default_rng(rows)
    B, width, k = 3, 1000, 777
    tables = _special_tables(rng, B, rows, width)
    keys = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (B, k)).astype(np.int32))
    keys[:, 0] = -1
    seeds = torch.tensor([0, 2**31 + 7, 2**32 - 1])
    want = countsketch.median(
        ref.countsketch_query_batched_ref(tables, keys, seeds), 1)
    fused = rows <= tq.MAX_FUSED_ROWS
    counters = lambda: (tq.launches, tq.single_launches,  # noqa: E731
                        tq.estimate_launches, tq.estimate_single_launches)
    before = counters()
    got = tq.countsketch_estimate_batched(tables.cuda(), keys.cuda(),
                                          seeds.cuda()).cpu()
    assert _same(got, want)
    one = tq.countsketch_estimate(tables[1].cuda(), keys[1].cuda(),
                                  int(seeds[1])).cpu()
    assert _same(one, want[1])
    assert _same(one, ref.countsketch_estimate_ref(tables[1], keys[1],
                                                   int(seeds[1])))
    after = [a - b for a, b in zip(counters(), before)]
    assert after == ([0, 0, 1, 1] if fused else [1, 1, 0, 0])
    assert got.isnan().any() and got.isfinite().any()


def test_cuda_estimate_at_the_flush_shape():
    """The sparse flush's refresh shape, 512 candidates + 5120 batch keys
    over 7 x 2048 tables (256 streams of the 4096), and empty keys."""
    _need_card()
    rng = np.random.default_rng(21)
    tables = torch.from_numpy(
        rng.normal(size=(256, 7, 2048)).astype(np.float32))
    keys = torch.from_numpy(
        rng.integers(0, 2**20, (256, 5632)).astype(np.int32))
    keys[:, :512] = -1
    seeds = hashing.hash_u32(torch.arange(256), 5)
    got = tq.countsketch_estimate_batched(tables.cuda(), keys.cuda(),
                                          seeds.cuda()).cpu()
    assert _same(got, ref.countsketch_estimate_batched_ref(tables, keys,
                                                           seeds))
    empty = tq.countsketch_estimate_batched(
        tables.cuda(), keys[:, :0].contiguous().cuda(), seeds.cuda())
    assert empty.shape == (256, 0)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    keys = torch.zeros((2, 8), dtype=torch.int64, device="cuda")
    vals = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError, match="int32"):
        ts.countsketch_scatter_batched(keys, vals, 5, 384, 0, p=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tq.countsketch_query_batched(
            torch.zeros((2, 384, 5), device="cuda").transpose(1, 2),
            keys.to(torch.int32), 0)
    with pytest.raises(ValueError, match="contiguous"):
        tq.countsketch_estimate_batched(
            torch.zeros((2, 384, 5), device="cuda").transpose(1, 2),
            keys.to(torch.int32), 0)
    with pytest.raises(ValueError, match="int32"):
        tq.countsketch_estimate_batched(torch.zeros((2, 5, 384),
                                                    device="cuda"), keys, 0)
    with pytest.raises(ValueError, match="unknown scheme"):
        ts.countsketch_scatter_batched(keys.to(torch.int32), vals, 5, 384,
                                       0, p=1.0, scheme="bogus")


def test_engine_on_card_matches_cpu():
    """The same stream through the engine on the card (kernels) and on the
    CPU (plain versions): allclose tables, identical sample keys."""
    _need_card()
    cfg = EngineConfig(num_streams=4, rows=6, width=1000, candidates=64)
    # every step (256 or 320 events) reaches the threshold: one flush each
    card = SketchEngine(cfg, flush_elems=256)
    cpu = SketchEngine(cfg, flush_elems=256, device="cpu")
    stream = TurnstileZipfStream(vocab_size=5000, alpha=1.2, seed=3)
    before = (ts.launches, tq.launches, tq.estimate_launches)
    for t in range(3):
        batches = [stream.sparse_batch_at(t, b, 256) for b in range(4)]
        keys = np.stack([k for k, _ in batches])
        vals = np.stack([v for _, v in batches])
        card.ingest(keys, vals)
        cpu.ingest(keys, vals)
    card_sample = card.sample(16)
    assert ts.launches == before[0] + 3
    assert tq.launches == before[1]  # every estimate is the estimate kernel
    assert tq.estimate_launches >= before[2] + 4
    want = cpu.state.sketch.table
    torch.testing.assert_close(card.state.sketch.table.cpu(), want,
                               rtol=RTOL, atol=_atol(want))
    assert torch.equal(card_sample.keys.cpu(), cpu.sample(16).keys)


# name -> (B, n, rows, width, kernel options); "lengths"/"base" per stream
UPDATE_CASES = {
    "B1_n1": (1, 1, 7, 2048, dict(p=1.0)),
    "W1000": (8, 1000, 5, 1000, dict(p=1.0)),
    "zero_length": (4, 300, 7, 2048, dict(p=1.0, lengths=[300, 0, 137, 1])),
    "lengths_past_n": (4, 300, 7, 2048,
                       dict(p=1.0, lengths=[300, 301, 5000, 2**31 - 1])),
    "base_key_wrap": (4, 300, 7, 2048,
                      dict(p=1.0, base=[2**31 - 100, 2**32 - 5, 7,
                                        2**32 - 1])),
    "priority": (4, 300, 7, 2048, dict(p=1.0, scheme="priority")),
    "p_half": (4, 300, 7, 2048, dict(p=0.5)),
    "p_two": (4, 300, 7, 2048, dict(p=2.0)),
    "no_transform": (4, 300, 7, 2048, dict(p=None)),
}


def _dense_opts(opts, device):
    kw = dict(opts)
    for name, key in (("lengths", "lengths"), ("base", "base_keys")):
        if name in kw:
            kw[key] = torch.tensor(kw.pop(name), device=device)
    return kw


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_cuda_update_matches_plain(case, variant):
    _need_card()
    B, n, rows, width, opts = UPDATE_CASES[case]
    _, vals, seeds, tseeds = _streams(B, n, seed=5)
    kw = _dense_opts(opts, "cpu")
    want = ref.countsketch_update_batched_ref(vals, rows, width, seeds,
                                              transform_seeds=tseeds, **kw)
    before = (tu.launches, tu.variant_launches[variant])
    got = tu.countsketch_update_batched(
        vals.cuda(), rows, width, seeds.cuda(), transform_seeds=tseeds.cuda(),
        **_dense_opts(opts, "cuda"), _variant=variant).cpu()
    assert (tu.launches, tu.variant_launches[variant]) == (before[0] + 1,
                                                           before[1] + 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=_atol(want))
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        vals, rows, width, seeds, transform_seeds=tseeds, **kw))
    assert bool(((got - want).abs() <= tol).all())
    if "lengths" in opts and 0 in opts["lengths"]:
        assert not got[opts["lengths"].index(0)].any()


def test_cuda_single_stream_update_and_query():
    """The B = 1 entry points: one segment's sketch within the scatter
    bounds, its query and estimate bit for bit."""
    _need_card()
    vals = torch.from_numpy(
        np.random.default_rng(2).normal(size=5000).astype(np.float32))
    base, seed, tseed = 2**32 - 2500, 2**31 + 5, 77
    want = ref.countsketch_update_ref(vals, base, 7, 2048, seed, p=1.0,
                                      transform_seed=tseed)
    before = (tu.launches, tu.single_launches)
    got = tu.countsketch_update(vals.cuda(), 7, 2048, seed, p=1.0,
                                transform_seed=tseed, base_key=base).cpu()
    assert (tu.launches, tu.single_launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=_atol(want))
    tol = ref.scatter_tolerance(*ref.countsketch_update_mass_ref(
        vals[None], 7, 2048, seed, p=1.0, transform_seeds=tseed,
        base_keys=base))[0]
    assert bool(((got - want).abs() <= tol).all())
    keys = torch.arange(-256, 256, dtype=torch.int32)
    before = (tq.launches, tq.single_launches, tq.estimate_single_launches)
    rows = tq.countsketch_query(want.cuda(), keys.cuda(), seed).cpu()
    est = tq.countsketch_estimate(want.cuda(), keys.cuda(), seed).cpu()
    assert (tq.launches, tq.single_launches, tq.estimate_single_launches) \
        == (before[0], before[1] + 1, before[2] + 1)
    assert torch.equal(rows, ref.countsketch_query_ref(want, keys, seed))
    assert torch.equal(est, ref.countsketch_estimate_ref(want, keys, seed))


# the transform seed and key of the reference's uniform01 == 1.0 edge
EDGE_SEED, EDGE_KEY = 0, 17691050


def _on_card(x, misaligned):
    """``x`` on the card; where ``misaligned``, as a view one element into
    a copy, so it starts 4 (int32, float32) or 2 (bfloat16) bytes past 16."""
    if not misaligned:
        return x.cuda()
    return torch.cat([x[:1], x]).cuda()[1:]


def _check_transform(keys, vals, p, seed, variant="vector"):
    """The transform of CPU keys/values on the card against its plain
    version: allclose at the dtype's tolerance, the infinities equal with
    their signs; the launch takes ``variant``, "scalar" through views one
    element in (by alignment)."""
    before = (tt.launches, dict(tt.variant_launches))
    misaligned = variant == "scalar"
    got = tt.ppswor_transform(_on_card(keys, misaligned),
                              _on_card(vals, misaligned), p, seed).cpu()
    assert tt.launches == before[0] + 1
    assert tt.variant_launches[variant] == before[1][variant] + 1
    want = ref.ppswor_transform_ref(keys, vals, p, seed)
    assert got.dtype == vals.dtype
    bf16 = vals.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=2e-2 if bf16 else 1e-5,
                               atol=1e-2 if bf16 else 1e-6)
    inf = want.isinf()
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    return want


@pytest.mark.parametrize("variant", ["vector", "scalar"])
@pytest.mark.parametrize("p", [0.5, 1.0, 1.5, 2.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_transform_matches_plain(dtype, p, variant):
    """Both variants at p = 0.5, 1, 2 (the intrinsics) and 1.5 (powf), at n
    not a multiple of the vector width, with the edge key among the keys,
    so that its infinity's sign is compared."""
    _need_card()
    rng = np.random.default_rng(4)
    n = 100_003
    keys = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
    keys[77] = EDGE_KEY
    vals = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(
        getattr(torch, dtype))
    vals[77] = -1.5
    want = _check_transform(keys, vals, p, EDGE_SEED, variant=variant)
    assert bool(want[77].isinf())
    _check_transform(keys, vals, p, 2**32 - 3, variant=variant)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_transform_variant_by_alignment(dtype):
    """A view that starts 4 (or 2) bytes in takes the scalar variant, by
    alignment; lengths below and around the vector width take the vector
    variant's tail."""
    _need_card()
    rng = np.random.default_rng(6)
    keys = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, 5000).astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(size=5000).astype(np.float32)).to(
        getattr(torch, dtype)).cuda()
    assert tt.variant(keys, vals) == "vector"
    assert tt.variant(keys[1:], vals[1:]) == "scalar"
    _check_transform(keys[1:].cpu(), vals[1:].cpu(), 1.0, 9)  # a copy
    before = dict(tt.variant_launches)
    got = tt.ppswor_transform(keys[1:], vals[1:], 1.0, 9)
    assert tt.variant_launches["scalar"] == before["scalar"] + 1
    torch.testing.assert_close(
        got.float().cpu(),
        ref.ppswor_transform_ref(keys[1:].cpu(), vals[1:].cpu(), 1.0,
                                 9).float(),
        rtol=2e-2 if dtype == "bfloat16" else 1e-5,
        atol=1e-2 if dtype == "bfloat16" else 1e-6)
    for n in (1, 3, 7, 8, 9, 17):
        _check_transform(keys[:n].cpu(), vals[:n].cpu(), 1.0, 9)


def test_update_dense_on_card_matches_cpu():
    """The same dense steps through the engine on the card (kernels) and
    on the CPU (plain versions): allclose tables, identical candidates and
    sample keys."""
    _need_card()
    cfg = EngineConfig(num_streams=3, rows=6, width=1000, candidates=64)
    card = SketchEngine(cfg)
    cpu = SketchEngine(cfg, device="cpu")
    rng = np.random.default_rng(8)
    base, lengths = [0, 2**31 - 500, 2**32 - 300], [2000, 1000, 1500]
    before = (tu.launches, tq.launches, tq.estimate_launches)
    for _ in range(3):
        vals = (rng.normal(size=(3, 2000))
                * np.exp(1.5 * rng.normal(size=(3, 2000)))).astype(np.float32)
        card.update_dense(vals, base_keys=base, lengths=lengths)
        cpu.update_dense(vals, base_keys=base, lengths=lengths)
    card_sample = card.sample(16)
    assert tu.launches == before[0] + 3
    assert tq.launches == before[1]  # every estimate is the estimate kernel
    assert tq.estimate_launches >= before[2] + 4
    want = cpu.state.sketch.table
    torch.testing.assert_close(card.state.sketch.table.cpu(), want,
                               rtol=RTOL, atol=_atol(want))
    assert torch.equal(card.state.cand_keys.cpu(), cpu.state.cand_keys)
    assert torch.equal(card_sample.keys.cpu(), cpu.sample(16).keys)


def test_cuda_new_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    vals = torch.zeros((2, 8), device="cuda")
    keys = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tu.countsketch_update_batched(vals.to(torch.int32), 5, 384, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tu.countsketch_update_batched(torch.zeros((8, 2), device="cuda").T,
                                      5, 384, 0)
    with pytest.raises(ValueError, match="unknown scheme"):
        tu.countsketch_update_batched(vals, 5, 384, 0, p=1.0, scheme="bogus")
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        tu.countsketch_update(torch.zeros(8, device="meta"), 5, 384, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tt.ppswor_transform(keys, vals[0].to(torch.float16), 1.0, 0)
    with pytest.raises(ValueError, match="int32"):
        tt.ppswor_transform(keys.to(torch.int64), vals[0], 1.0, 0)
    with pytest.raises(ValueError, match="device"):
        tt.ppswor_transform(keys.cpu(), vals[0], 1.0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tq.countsketch_query(torch.zeros((384, 5), device="cuda").T, keys, 0)


# -- the shared-memory table kernels: their plans and edges -----------------

def _scatter_case(keys, vals, rows, width, seeds, tseeds, lengths=None,
                  variant=None, p=1.0):
    """The scatter of (B, n) CPU inputs on the card against its plain
    version within both bounds; returns the kernel's delta (on the CPU) and
    the variant it launched."""
    before = dict(ts.variant_launches)
    got = ts.countsketch_scatter_batched(
        keys.cuda(), vals.cuda(), rows, width, seeds.cuda(), p=p,
        transform_seeds=tseeds.cuda(),
        lengths=None if lengths is None else torch.tensor(lengths).cuda(),
        _variant=variant).cpu()
    kw = dict(p=p, transform_seeds=tseeds,
              lengths=None if lengths is None else torch.tensor(lengths))
    _check_sum(got, ref.countsketch_scatter_batched_ref(
        keys, vals, rows, width, seeds, **kw),
        ref.countsketch_scatter_mass_ref(keys, vals, rows, width, seeds,
                                         **kw))
    ran = [v for v in before if ts.variant_launches[v] == before[v] + 1]
    assert len(ran) == 1
    return got, ran[0]


def _update_case(vals, rows, width, seeds, tseeds, variant=None, **kw):
    """The dense update of (B, n) CPU values on the card against its plain
    version within both bounds; returns the kernel's delta (on the CPU)
    and the variant it launched."""
    before = dict(tu.variant_launches)
    got = tu.countsketch_update_batched(
        vals.cuda(), rows, width, seeds.cuda(), p=1.0,
        transform_seeds=tseeds.cuda(),
        **{k: torch.tensor(v).cuda() for k, v in kw.items()},
        _variant=variant).cpu()
    kw = {k: torch.tensor(v) for k, v in kw.items()}
    _check_sum(got, ref.countsketch_update_batched_ref(
        vals, rows, width, seeds, p=1.0, transform_seeds=tseeds, **kw),
        ref.countsketch_update_mass_ref(vals, rows, width, seeds, p=1.0,
                                        transform_seeds=tseeds, **kw))
    ran = [v for v in before if tu.variant_launches[v] == before[v] + 1]
    assert len(ran) == 1
    return got, ran[0]


@pytest.mark.parametrize("variant", ["smem", "global"])
def test_cuda_scatter_hot_key(variant):
    """One key repeated n times: every lane of a warp adds to the same 7
    cells."""
    _need_card()
    _, vals, seeds, tseeds = _streams(4, 5000, seed=11)
    keys = torch.full((4, 5000), 12345, dtype=torch.int32)
    keys[1, ::3] = 7
    got, ran = _scatter_case(keys, vals, 7, 2048, seeds, tseeds,
                             variant=variant)
    assert ran == variant
    assert int((got[0] != 0).sum()) <= 7


def test_cuda_scatter_one_block_per_stream_writes_whole_delta():
    """Where each stream is one block, the delta comes from torch.empty and
    every cell is written: an all-padding stream and an empty stream among
    live ones are exactly zero even where the memory held NaNs."""
    _need_card()
    B, n = 1200, 600  # enough streams to fill the card one block each
    keys, vals, seeds, tseeds = _streams(B, n, seed=12)
    keys[1] = -1
    lengths = [n] * B
    lengths[2], lengths[3] = 0, 234
    plan = tiling.table_plan(B, n, np.array(lengths), 7, 2048,
                             tiling.sm_count("cuda"))
    assert plan.one_per_stream
    junk = torch.full((B, 7, 2048), float("nan"), device="cuda")
    del junk  # the caching allocator hands this block to torch.empty
    got, ran = _scatter_case(keys, vals, 7, 2048, seeds, tseeds,
                             lengths=lengths)
    assert ran == "smem" and got.isfinite().all()
    assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("width", [384, 1984])
@pytest.mark.parametrize("variant", ["smem", "global"])
def test_cuda_tables_at_widths_not_a_power_of_two(width, variant):
    _need_card()
    keys, vals, seeds, tseeds = _streams(3, 2000, seed=width)
    _scatter_case(keys, vals, 7, width, seeds, tseeds, variant=variant)
    _update_case(vals, 7, width, seeds, tseeds, variant=variant,
                 lengths=[2000, 777, 0])


def test_cuda_table_too_large_for_shared_memory_takes_global():
    """rows 7 x width 16384 (458,752 B) does not fit a block: the wrappers
    launch the global-atomic kernels, by shape."""
    _need_card()
    keys, vals, seeds, tseeds = _streams(2, 3000, seed=13)
    assert _scatter_case(keys, vals, 7, 16384, seeds, tseeds)[1] == "global"
    assert _update_case(vals, 7, 16384, seeds, tseeds,
                        lengths=[3000, 1001])[1] == "global"
    with pytest.raises(ValueError, match="does not fit"):
        ts.countsketch_scatter_batched(keys.cuda(), vals.cuda(), 7, 16384,
                                       seeds.cuda(), _variant="smem")


def test_cuda_update_chunks_with_ragged_lengths_and_key_wrap():
    """Dense streams of several chunks, lengths not a multiple of the
    chunk, an empty stream, and a segment whose keys wrap through
    0xFFFFFFFF in the middle of a chunk (that key is sketched)."""
    _need_card()
    n = 200_000
    _, vals, seeds, tseeds = _streams(4, n, seed=14)
    lengths = [n, 77_123, 0, 150_001]
    base = [0, 2**31 - 500, 5, 2**32 - 100_000]
    plan = tiling.table_plan(4, n, np.array(lengths), 7, 2048,
                             tiling.sm_count("cuda"))
    assert not plan.one_per_stream
    assert any(length % plan.chunk for length in lengths)
    got, ran = _update_case(vals, 7, 2048, seeds, tseeds, lengths=lengths,
                            base_keys=base)
    assert ran == "smem" and not got[2].any()
    only = torch.zeros_like(vals)
    only[3, 99_999] = 1.0  # key 0xFFFFFFFF alone
    assert _update_case(only, 7, 2048, seeds, tseeds, lengths=lengths,
                        base_keys=base)[0][3].abs().sum() > 0


def test_cuda_single_segment_over_several_chunks():
    """#4: one segment (B = 1) planned over several chunks."""
    _need_card()
    n = 150_000
    vals = torch.from_numpy(
        np.random.default_rng(15).normal(size=n).astype(np.float32))
    plan = tiling.table_plan(1, n, np.array([n]), 7, 2048,
                             tiling.sm_count("cuda"))
    assert not plan.one_per_stream and plan.blocks >= 2
    seed, tseed, base = 2**31 + 9, 3, 2**32 - 70_000
    before = (tu.single_launches, tu.variant_launches["smem"])
    got = tu.countsketch_update(vals.cuda(), 7, 2048, seed, p=1.0,
                                transform_seed=tseed, base_key=base).cpu()
    assert (tu.single_launches, tu.variant_launches["smem"]) == (
        before[0] + 1, before[1] + 1)
    _check_sum(got, ref.countsketch_update_ref(
        vals, base, 7, 2048, seed, p=1.0, transform_seed=tseed),
        [t[0] for t in ref.countsketch_update_mass_ref(
            vals[None], 7, 2048, seed, p=1.0, transform_seeds=tseed,
            base_keys=base)])


def test_core_entry_points_default_to_the_card():
    """No device and plain seeds: the state lands on the card."""
    _need_card()
    spec = make_sampler("onepass", SamplerConfig(rows=5, width=384,
                                                 candidates=16))
    for st in (worp.onepass_init(5, 384, 10, 3, 4), spec.init(3, 4)):
        assert {t.device.type for t in (st.sketch.table, st.sketch.seed,
                                         st.cand_keys, st.seed_transform)} \
            == {"cuda"}
    assert countsketch.init(5, 384, 3).table.device.type == "cuda"


def _separated(B, n, seed, domain=400):
    """Integer-valued keys and values, keys % 7 == 0 twenty times heavier:
    well separated, and exact in any summation order."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, domain, (B, n)).astype(np.int32)
    vals = np.round((rng.random((B, n)) + 0.5)
                    * (1 + (keys % 7 == 0) * 20)).astype(np.float32)
    return keys, vals


def _sampler_pair(name, B=4):
    cfg = EngineConfig(num_streams=B, rows=5, width=256, candidates=32,
                       capacity=32, sampler=name, domain=400, num_samplers=3)
    return (SketchEngine(cfg, flush_elems=40),
            SketchEngine(cfg, flush_elems=40, device="cpu"))


def _launches():
    return (ts.launches, ts.variant_launches["smem"], tq.estimate_launches,
            tq.launches)


@pytest.mark.parametrize("name", ["twopass", "tv"])
def test_sampler_sparse_path_on_card_matches_cpu(name):
    """The twopass and tv sparse paths on the card (scatter and estimate
    kernels) against the same engine on the CPU (plain versions): tables
    within both bounds' allclose, buffers and sample keys identical, exact
    frequencies equal; the launches per flush as the paths state them."""
    _need_card()
    card, cpu = _sampler_pair(name)
    keys, vals = _separated(4, 120, seed=1)
    before = _launches()
    for i in range(3):
        sl = slice(40 * i, 40 * i + 40)
        card.ingest(keys[:, sl], vals[:, sl])
        cpu.ingest(keys[:, sl], vals[:, sl])
    card.flush()
    ran = tuple(a - b for a, b in zip(_launches(), before))
    per_flush = (1, 1, 2, 0) if name == "twopass" else (2, 2, 2, 0)
    assert ran == tuple(3 * x for x in per_flush)
    got, want = card.state, cpu.state
    if name == "twopass":
        pairs = [(got.pass1.sketch.table, want.pass1.sketch.table)]
        assert torch.equal(got.pass1.cand_keys.cpu(), want.pass1.cand_keys)
        assert torch.equal(got.pass2.keys.cpu(), want.pass2.keys)
        assert torch.equal(got.pass2.freqs.cpu(), want.pass2.freqs)
    else:
        pairs = [(got.sketches.table, want.sketches.table),
                 (got.rhh.sketch.table, want.rhh.sketch.table)]
        assert torch.equal(got.cand_keys.cpu(), want.cand_keys)
        assert torch.equal(got.rhh.cand_keys.cpu(), want.rhh.cand_keys)
    for g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, rtol=RTOL, atol=_atol(w))
    before = _launches()
    samp = card.sample(3)
    assert samp.keys.device.type == "cuda"
    ran = tuple(a - b for a, b in zip(_launches(), before))
    # twopass reads no sketch; tv: r draws and one read of the rHH
    assert ran == ((0, 0, 0, 0) if name == "twopass" else (0, 0, 4, 0))
    want = cpu.sample(3)
    assert torch.equal(samp.keys.cpu(), want.keys)
    if name == "tv":
        assert bool(samp.threshold.isnan().all())


def test_update_pass2_is_one_estimate_launch():
    _need_card()
    card, cpu = _sampler_pair("onepass")
    keys, vals = _separated(4, 120, seed=2)
    for eng in (card, cpu):
        eng.ingest(keys, vals)
        eng.freeze()
    assert card.pass2.keys.device.type == "cuda"
    for i in range(2):
        sl = slice(60 * i, 60 * i + 60)
        before = _launches()
        card.update_pass2(keys[:, sl], vals[:, sl])
        assert tuple(a - b for a, b in zip(_launches(), before)) \
            == (0, 0, 1, 0)
        cpu.update_pass2(keys[:, sl], vals[:, sl])
    got, want = card.sample_exact(5), cpu.sample_exact(5)
    assert torch.equal(got.keys.cpu(), want.keys)
    assert torch.equal(got.freqs.cpu(), want.freqs)


def test_perfect_sampler_launches_no_kernel():
    _need_card()
    card, cpu = _sampler_pair("perfect")
    keys, vals = _separated(4, 120, seed=3)
    before = (_launches(), tu.launches, tu.single_launches, tt.launches,
              tq.single_launches, tq.estimate_single_launches)
    card.ingest(keys, vals)
    cpu.ingest(keys, vals)
    samp = card.sample(5)
    assert (_launches(), tu.launches, tu.single_launches, tt.launches,
            tq.single_launches, tq.estimate_single_launches) == before
    assert card.state.freqs.device.type == "cuda"
    assert torch.equal(card.state.freqs.cpu(), cpu.state.freqs)
    assert torch.equal(samp.keys.cpu(), cpu.sample(5).keys)


# ---------------------------------------------------------------------------
# the deterministic mode: the scatter's "det" variant, PyTorch's segment
# sums, and the async plane against the sparse plane bit for bit
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)``, restored after."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


DET_CASES = {
    "ppswor_p1": dict(p=1.0),
    "priority": dict(p=1.0, scheme="priority"),
    "p_half": dict(p=0.5),
    "no_transform": dict(p=None),
    "padding_and_lengths": dict(p=1.0, pad_stream=1,
                                lengths=[2500, 2500, 0, 1537]),
    "hot_key": dict(p=1.0, hot=True),
}


@pytest.mark.parametrize("case", sorted(DET_CASES))
def test_cuda_det_scatter_same_bits_every_launch(case):
    """Under the deterministic mode the scatter takes its "det" variant by
    itself; three launches give the same bits, and each cell is within its
    rounding bound of the plain version (stages of 256 slots: 2500 slots
    make ten, the last part full)."""
    _need_card()
    opts = dict(DET_CASES[case])
    keys, vals, seeds, tseeds = _streams(4, 2500, seed=21)
    if opts.pop("hot", False):
        keys[:, ::2] = 4242
    pad = opts.pop("pad_stream", None)
    if pad is not None:
        keys[pad] = -1
    lengths = opts.pop("lengths", None)
    lengths = None if lengths is None else torch.tensor(lengths)
    want = ref.countsketch_scatter_batched_ref(
        keys, vals, 7, 2048, seeds, transform_seeds=tseeds, lengths=lengths,
        **opts)
    outs = []
    with _deterministic():
        for _ in range(3):
            before = dict(ts.variant_launches)
            outs.append(ts.countsketch_scatter_batched(
                keys.cuda(), vals.cuda(), 7, 2048, seeds.cuda(),
                transform_seeds=tseeds.cuda(),
                lengths=None if lengths is None else lengths.cuda(),
                **opts).cpu())
            assert {v: ts.variant_launches[v] - before[v]
                    for v in before} == {"smem": 0, "global": 0, "det": 1}
    assert all(torch.equal(o.view(torch.int32), outs[0].view(torch.int32))
               for o in outs[1:])
    _check_sum(outs[0], want, ref.countsketch_scatter_mass_ref(
        keys, vals, 7, 2048, seeds, transform_seeds=tseeds, lengths=lengths,
        **opts))
    if pad is not None:
        assert not outs[0][pad].any() and not outs[0][2].any()


def _det_case(case, seed=21):
    """DET_CASES' layout: (4, 2500) streams, hot key, padding, lengths."""
    opts = dict(DET_CASES[case])
    keys, vals, seeds, tseeds = _streams(4, 2500, seed=seed)
    if opts.pop("hot", False):
        keys[:, ::2] = 4242
    pad = opts.pop("pad_stream", None)
    if pad is not None:
        keys[pad] = -1
    lengths = opts.pop("lengths", None)
    lengths = None if lengths is None else torch.tensor(lengths)
    return keys, vals, seeds, tseeds, lengths, opts


def _det_launch(keys, vals, seeds, tseeds, lengths, **opts):
    with _deterministic():
        return ts.countsketch_scatter_batched(
            keys.cuda(), vals.cuda(), 7, 2048, seeds.cuda(),
            transform_seeds=tseeds.cuda(),
            lengths=None if lengths is None else lengths.cuda(),
            **opts).cpu()


@pytest.mark.parametrize("case", sorted(DET_CASES))
def test_cuda_det_scatter_equals_order_model_bitwise(case):
    """Without the transform the det kernel gives the bits of the plain
    model of its summation order (``ref.countsketch_scatter_det_ref``),
    over every DET_CASES layout."""
    _need_card()
    keys, vals, seeds, tseeds, lengths, opts = _det_case(case)
    opts["p"] = None
    got = _det_launch(keys, vals, seeds, tseeds, lengths, **opts)
    want = ref.countsketch_scatter_det_ref(
        keys, vals, 7, 2048, seeds, transform_seeds=tseeds, lengths=lengths,
        **opts)
    assert _same_bits(got, want)


@pytest.mark.parametrize("case", sorted(c for c in DET_CASES
                                        if DET_CASES[c].get("p")
                                        and "scheme" not in DET_CASES[c]))
def test_cuda_det_scatter_fused_transform_equals_model_bitwise(case):
    """With ``p`` set the det kernel's fused transform gives the bits of
    the ppswor_transform kernel's: the det kernel equals the order model
    fed the values that kernel transformed, stream by stream."""
    _need_card()
    keys, vals, seeds, tseeds, lengths, opts = _det_case(case)
    got = _det_launch(keys, vals, seeds, tseeds, lengths, **opts)
    tvals = torch.stack([tt.ppswor_transform(
        keys[b].cuda(), vals[b].cuda(), opts["p"], int(tseeds[b])).cpu()
        for b in range(keys.shape[0])])
    want = ref.countsketch_scatter_det_ref(
        keys, tvals, 7, 2048, seeds, lengths=lengths)
    assert _same_bits(got, want)


@pytest.mark.parametrize("width", [40_000, 57_072])
def test_cuda_det_scatter_wide_table_equals_order_model_bitwise(width):
    """Past 2**15 buckets the det kernel stages 32-bit (bucket, sign)
    entries (a one-row table fits a block up to 57,072 buckets): on Zipf
    keys with a hot key, a padding stream and lengths, three launches give
    the same bits, which without the transform are the order model's bit
    for bit, and with it lie within the rounding bound of the plain
    version."""
    _need_card()
    assert tiling.det_entry_bytes(width) == 4 and tiling.det_fits(1, width)
    rng = np.random.default_rng(width)
    keys = torch.from_numpy(np.minimum(rng.zipf(1.2, (6, 3000)) - 1,
                                       2**20).astype(np.int32))
    keys[:, ::5] = 4242
    keys[1] = -1
    vals = torch.from_numpy(rng.normal(size=(6, 3000)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 2**32, 6, dtype=np.int64))
    tseeds = torch.from_numpy(rng.integers(0, 2**32, 6, dtype=np.int64))
    lengths = torch.tensor([3000, 3000, 0, 1, 257, 2999])
    for p in (None, 1.0):
        opts = dict(p=p, transform_seeds=tseeds, lengths=lengths)
        outs = []
        with _deterministic():
            for _ in range(3):
                before = dict(ts.variant_launches)
                outs.append(ts.countsketch_scatter_batched(
                    keys.cuda(), vals.cuda(), 1, width, seeds.cuda(),
                    transform_seeds=tseeds.cuda(), lengths=lengths.cuda(),
                    p=p).cpu())
                assert {v: ts.variant_launches[v] - before[v]
                        for v in before} == {"smem": 0, "global": 0,
                                             "det": 1}
        assert all(_same_bits(o, outs[0]) for o in outs[1:])
        if p is None:
            assert _same_bits(outs[0], ref.countsketch_scatter_det_ref(
                keys, vals, 1, width, seeds, **opts))
        else:  # the plain version on the card, as chip_smoke.py's
            dev = [t.cuda() for t in (keys, vals, seeds, tseeds, lengths)]
            kw = dict(p=p, transform_seeds=dev[3], lengths=dev[4])
            _check_sum(outs[0], ref.countsketch_scatter_batched_ref(
                *dev[:2], 1, width, dev[2], **kw).cpu(),
                [t.cpu() for t in ref.countsketch_scatter_mass_ref(
                    *dev[:2], 1, width, dev[2], **kw)])
        assert not outs[0][1].any() and not outs[0][2].any()


def _det_split_scatter(rows, width, seed):
    """The det scatter on a table too large for one block (split by
    ``tiling.det_split``): Zipf keys with a hot key, a padding stream and
    lengths; three launches give the same bits, each counted as one det
    launch, which without the transform are the order model's bit for bit
    and with it lie within the rounding bound of the plain version."""
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(np.minimum(rng.zipf(1.2, (6, 3000)) - 1,
                                       2**20).astype(np.int32))
    keys[:, ::5] = 4242
    keys[1] = -1
    vals = torch.from_numpy(rng.normal(size=(6, 3000)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 2**32, 6, dtype=np.int64))
    tseeds = torch.from_numpy(rng.integers(0, 2**32, 6, dtype=np.int64))
    lengths = torch.tensor([3000, 3000, 0, 1, 257, 2999])
    plan = tiling.table_plan(6, 3000, None, rows, width, 132,
                             deterministic=True)
    assert plan.row_group and tiling.det_parts(plan, rows) > 1
    for p in (None, 1.0):
        opts = dict(p=p, transform_seeds=tseeds, lengths=lengths)
        outs = []
        with _deterministic():
            for _ in range(3):
                before = dict(ts.variant_launches)
                outs.append(ts.countsketch_scatter_batched(
                    keys.cuda(), vals.cuda(), rows, width, seeds.cuda(),
                    transform_seeds=tseeds.cuda(), lengths=lengths.cuda(),
                    p=p).cpu())
                assert {v: ts.variant_launches[v] - before[v]
                        for v in before} == {"smem": 0, "global": 0,
                                             "det": 1}
        assert all(_same_bits(o, outs[0]) for o in outs[1:])
        if p is None:
            assert _same_bits(outs[0], ref.countsketch_scatter_det_ref(
                keys, vals, rows, width, seeds, **opts))
        else:
            dev = [t.cuda() for t in (keys, vals, seeds, tseeds, lengths)]
            kw = dict(p=p, transform_seeds=dev[3], lengths=dev[4])
            _check_sum(outs[0], ref.countsketch_scatter_batched_ref(
                *dev[:2], rows, width, dev[2], **kw).cpu(),
                [t.cpu() for t in ref.countsketch_scatter_mass_ref(
                    *dev[:2], rows, width, dev[2], **kw)])
        assert not outs[0][1].any() and not outs[0][2].any()


def test_cuda_det_scatter_table_too_large_raises():
    """A table past a block's shared memory (7 x 16,384, three row groups
    of 3, 3 and 1 rows) no longer raises in the mode: its split det launch
    gives the order model's bits (``_det_split_scatter``)."""
    _need_card()
    _det_split_scatter(7, 16_384, seed=22)


@pytest.mark.parametrize("rows,width", [(5, 12_400), (1, 57_856),
                                        (1, 100_000), (7, 100_000)])
def test_cuda_det_scatter_split_table_equals_order_model_bitwise(rows,
                                                                 width):
    """Split det scatters (``_det_split_scatter``): a cluster of five
    one-row CTAs a stream at 5 x 12,400 (``fleet_serve --verify --topk
    400``'s table); blocks of two bucket ranges of a row at 1 x 57,856
    (16-bit entries) and 1 x 100,000 (32-bit), and of each row at
    7 x 100,000."""
    _need_card()
    _det_split_scatter(rows, width, seed=rows + width)


@pytest.mark.parametrize("rows,width", [(7, 16_384), (5, 12_400),
                                        (1, 100_000), (7, 100_000)])
def test_cuda_det_scatter_split_single_stream_equals_order_model(rows,
                                                                width):
    """One stream (``countsketch_scatter``, B = 1) on a split table: over
    a cluster of five one-row CTAs (5 x 12,400), else over blocks that
    each hash every slot (row groups at 7 x 16,384, bucket ranges at
    1 x 100,000 and 7 x 100,000).  Three launches give the same bits,
    each a single-stream det launch, the order model's bit for bit; a hot
    key and padding included."""
    _need_card()
    rng = np.random.default_rng(rows * width)
    keys = torch.from_numpy(np.minimum(rng.zipf(1.2, 4999) - 1,
                                       2**20).astype(np.int32))
    keys[::7] = 4242
    keys[3::11] = -1
    vals = torch.from_numpy(rng.normal(size=4999).astype(np.float32))
    plan = tiling.table_plan(1, 4999, None, rows, width, 132,
                             deterministic=True)
    assert plan.row_group and bool(plan.cluster) is (width == 12_400)
    with _deterministic():
        before = (ts.single_launches, ts.variant_launches["det"])
        outs = [ts.countsketch_scatter(keys.cuda(), vals.cuda(), rows,
                                       width, 31).cpu() for _ in range(3)]
        assert (ts.single_launches - before[0],
                ts.variant_launches["det"] - before[1]) == (3, 3)
    assert all(_same_bits(o, outs[0]) for o in outs[1:])
    assert _same_bits(outs[0], ref.countsketch_scatter_det_ref(
        keys[None], vals[None], rows, width, 31)[0])


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


# the dense update's "det" variant: chunks of a segment summed in slot
# order, then in chunk order (B, n, lengths, base keys, rows, width, value
# type).  Widths 8,045 (rows 7) and 57,856 (rows 1) are the widest tables
# its plan admits (tiling.det_dense_fits), 3,000 and 8,045 take the
# ``hash % W`` path; "chunks" and the rest cross many chunk boundaries
# (the plan's chunk is a few thousand slots at these lengths)
DET_UPDATE_CASES = {
    "one_block_a_stream": (4, 500, [500, 0, 137, 1], [0, 2**32 - 5, 7,
                                                      2**31 - 100], 7, 2048,
                           torch.float32),
    "chunks": (3, 200_000, [200_000, 123_457, 4097], [5, 2**32 - 77_000,
                                                      2**31], 7, 2048,
               torch.float32),
    "rows1_widest": (2, 70_000, [70_000, 33_333], [9, 2**32 - 1], 1,
                     57_856, torch.float32),
    "rows5_width3000": (3, 100_000, [100_000, 99_999, 31], [0, 2**31 - 1,
                                                            17], 5, 3000,
                        torch.float32),
    "rows7_widest": (2, 150_000, [150_000, 77_777], [3, 2**32 - 60_000], 7,
                     8045, torch.float32),
    "rows8": (3, 120_000, [120_000, 65_536, 1], [1, 2, 2**31 + 5], 8, 2048,
              torch.float32),
    "bfloat16": (3, 80_000, [80_000, 40_001, 2048], [4, 2**32 - 100, 0], 7,
                 2048, torch.bfloat16),
    "one_segment": (1, 300_000, [300_000], [11], 7, 2048, torch.float32),
    # tables too large for one block, split (tiling.det_split): row groups
    # of 3, 3, 1 and of 4, 1 rows; two bucket ranges of one row
    "split_rows7_16384": (2, 150_000, [150_000, 77_777], [3, 2**32 - 60_000],
                          7, 16_384, torch.float32),
    "split_rows5_12400": (3, 100_000, [100_000, 0, 4097], [0, 5, 2**31],
                          5, 12_400, torch.float32),
    "split_rows1_100000": (2, 400_000, [400_000, 123_457], [9, 2**32 - 1],
                           1, 100_000, torch.float32),
    # one segment (B = 1) over a cluster of 7 row CTAs, 8 bucket-range CTAs
    "split_rows7_16384_one_segment": (1, 700_001, [700_001], [2**32 - 3], 7,
                                      16_384, torch.float32),
    "split_rows1_100000_one_segment": (1, 500_000, [499_999], [77], 1,
                                       100_000, torch.float32),
    # past what a cluster holds (7 x 100,000): the split of blocks that each
    # hash every slot, two bucket ranges of each row
    "split_rows7_100000_blocks": (2, 50_000, [50_000, 777], [1, 2**31 + 9],
                                  7, 100_000, torch.float32),
}


def _det_update(vals, seeds, tseeds, lengths, base, p, rows=7, width=2048,
                forced=None):
    """One update launch in the deterministic mode (on the card), checked
    to run the det variant; the (B, rows, width) table on the host."""
    with _deterministic():
        before = dict(tu.variant_launches)
        got = tu.countsketch_update_batched(
            vals.cuda(), rows, width, seeds.cuda(), p=p,
            transform_seeds=tseeds.cuda(), base_keys=base.cuda(),
            lengths=lengths.cuda(), _variant=forced).cpu()
        assert {v: tu.variant_launches[v] - before[v] for v in before} == {
            "smem": 0, "global": 0, "det": 1}
    return got


def _det_model(vals, seeds, tseeds, lengths, base, p, rows, width, chunk):
    """The order model (``ref.countsketch_update_det_ref`` at the plan's
    chunk) on the values the kernel sums: float32 (bfloat16 cast, as the
    wrapper does) and, with ``p``, transformed by the ppswor_transform
    kernel, whose bits are the fused transform's."""
    tvals = vals.to(torch.float32)
    if p is not None:
        n = vals.shape[1]
        keys = ((base[:, None] + torch.arange(n)) % 2**32).to(torch.int64)
        keys = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
        tvals = torch.stack([tt.ppswor_transform(
            keys[b].cuda(), tvals[b].cuda(), p, int(tseeds[b])).cpu()
            for b in range(vals.shape[0])])
    return ref.countsketch_update_det_ref(tvals, rows, width, seeds,
                                          base_keys=base, lengths=lengths,
                                          chunk=chunk)


@pytest.mark.parametrize("case", sorted(DET_UPDATE_CASES))
def test_cuda_det_update_same_bits_and_order_model(case):
    """Under the deterministic mode the dense update takes its "det"
    variant by itself (its launch counted): three launches give the same
    bits; without the transform they are the order model's
    (``ref.countsketch_update_det_ref`` at the plan's chunk) bit for bit,
    with it the order model's fed the values the ppswor_transform kernel
    gives; each cell is within its rounding bound of the plain version,
    and a zero-length segment is zero."""
    _need_card()
    B, n, lengths, base, rows, width, dtype = DET_UPDATE_CASES[case]
    rng = np.random.default_rng(n + rows)
    vals = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)).to(
        dtype)
    seeds = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.int64))
    tseeds = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.int64))
    lengths, base = torch.tensor(lengths), torch.tensor(base)
    plan = tiling.table_plan(B, n, lengths.numpy(), rows, width,
                             tiling.sm_count(torch.device("cuda")), "det",
                             det_chunks=True)
    group = plan.row_group or rows
    if plan.cluster:  # a cluster's CTAs: producers and walkers
        assert plan.cluster == tiling.det_parts(plan, rows) <= 8
        assert (plan.threads, plan.smem_bytes) == (
            tiling.det_threads(group), tiling.det_cluster_smem_bytes(
                plan.cluster, group, tiling.det_span(plan, width),
                tiling.det_clash_bits(plan, width)))
    else:
        assert (plan.threads, plan.smem_bytes) == (
            tiling.det_dense_threads(group),
            tiling.det_dense_smem_bytes(group, tiling.det_span(plan, width)))
    assert bool(plan.row_group) is case.startswith("split")
    assert bool(plan.cluster) is (case.startswith("split")
                                  and not case.endswith("blocks"))
    assert plan.one_per_stream is (case == "one_block_a_stream")
    kw = dict(transform_seeds=tseeds, base_keys=base, lengths=lengths)
    for p in (None, 1.0):
        outs = [_det_update(vals, seeds, tseeds, lengths, base, p, rows,
                            width) for _ in range(3)]
        assert all(_same_bits(o, outs[0]) for o in outs[1:])
        want = _det_model(vals, seeds, tseeds, lengths, base, p, rows,
                          width, plan.chunk)
        assert _same_bits(outs[0], want)
        plain = ref.countsketch_update_batched_ref(vals, rows, width, seeds,
                                                   p=p, **kw)
        _check_sum(outs[0], plain, ref.countsketch_update_mass_ref(
            vals, rows, width, seeds, p=p, **kw))
        for b, length in enumerate(lengths.tolist()):
            assert length or not outs[0][b].any()


def test_cuda_det_update_single_segment_and_dense_entry_points():
    """``countsketch_update`` (one segment, 6 chunks here) and
    ``ops.sketch_dense_vector`` launch the det variant in the mode, with
    the same bits every time, the order model's at the plan's chunk (with
    and without the transform, a bfloat16 segment too), each launch
    counted as a single-segment det launch; ``update_dense`` twice from one
    state gives the same state bit for bit."""
    _need_card()
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.normal(size=300_000).astype(np.float32)).cuda()
    plan = tiling.table_plan(1, v.numel(), np.array([v.numel()]), 7, 2048,
                             tiling.sm_count(v.device), "det",
                             det_chunks=True)
    assert not plan.one_per_stream and plan.blocks > 1
    one = torch.tensor([v.numel()])
    with _deterministic():
        for x, p in ((v, 1.0), (v, None), (v.to(torch.bfloat16), 1.0)):
            before = (tu.single_launches, tu.variant_launches["det"])
            outs = [tu.countsketch_update(x, 7, 2048, 99, p=p,
                                          transform_seed=3, base_key=11)
                    for _ in range(2)]
            outs.append(ops.sketch_dense_vector(x, 7, 2048, 99, p=p,
                                                transform_seed=3,
                                                base_key=11))
            assert (tu.single_launches - before[0],
                    tu.variant_launches["det"] - before[1]) == (3, 3)
            assert all(_same_bits(o, outs[0]) for o in outs[1:])
            want = _det_model(x[None].cpu(), torch.tensor([99]),
                              torch.tensor([3]), one, torch.tensor([11]), p,
                              7, 2048, plan.chunk)[0]
            assert _same_bits(outs[0].cpu(), want)
        cfg = EngineConfig(num_streams=3, rows=7, width=2048, candidates=64)
        grads = torch.from_numpy(rng.normal(size=(3, 70_000)).astype(
            np.float32)).cuda()
        states = []
        for _ in range(2):
            eng = SketchEngine(cfg, plane="sparse", device="cuda")
            eng.update_dense(grads, lengths=torch.tensor([70_000, 5, 1000]))
            states.append(eng.state)
        assert all(_same_bits(a, b) if a.is_floating_point()
                   else torch.equal(a, b)
                   for a, b in zip(_leaves(states[0]), _leaves(states[1])))


def test_cuda_det_update_table_too_large_raises():
    """A dense table past a block's shared memory (7 x 16,384) no longer
    raises in the mode: one 300-slot segment a cluster of seven one-row
    CTAs, launched once, gives the order model's bits every time."""
    _need_card()
    before = tu.launches
    vals = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 300)).astype(np.float32))
    with _deterministic():
        outs = [tu.countsketch_update_batched(vals.cuda(), 7, 16384, 5)
                .cpu() for _ in range(3)]
    assert tu.launches == before + 3
    plan = tiling.table_plan(2, 300, np.array([300, 300]), 7, 16384,
                             tiling.sm_count(torch.device("cuda")), "det",
                             det_chunks=True)
    assert plan.one_per_stream and (plan.row_group, plan.cluster) == (1, 7)
    assert all(_same_bits(o, outs[0]) for o in outs[1:])
    assert _same_bits(outs[0], ref.countsketch_update_det_ref(
        vals, 7, 16384, 5, chunk=plan.chunk))


def test_scatter_add_and_index_add_deterministic_at_flush_shapes():
    """The flush's PyTorch sums under the mode, twice each on the same
    inputs, at the sparse plane's shapes (B = 4096, n = 5120, 512
    candidates): ``_dedup_topc``'s ``scatter_add_`` over (4096, 5632) with
    Zipf-like repeated keys, the perfect spec's over a (256, 2**20) domain,
    and ``countsketch.update``'s ``index_add_`` into 4096 x 7 x 2048
    cells."""
    _need_card()
    rng = np.random.default_rng(23)
    B, n, C = 4096, 5120, 512
    keys = torch.from_numpy(np.minimum(rng.zipf(1.2, (B, C + n)) - 1,
                                       2**20 - 1).astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.normal(size=(B, C + n)).astype(
        np.float32)).cuda()
    with _deterministic():
        a = worp._dedup_topc(keys, vals, vals.abs(), C)
        b = worp._dedup_topc(keys, vals, vals.abs(), C)
        assert all(_same_bits(x, y) for x, y in zip(a, b))
        spec = make_sampler("perfect", SamplerConfig(domain=2**20))
        st = spec.init(torch.arange(256).cuda(), torch.arange(256).cuda())
        f1 = spec.update(st, keys[:256, :n], vals[:256, :n]).freqs
        f2 = spec.update(st, keys[:256, :n], vals[:256, :n]).freqs
        assert _same_bits(f1, f2)
        sk = countsketch.init(7, 2048, torch.arange(B).cuda())
        t1 = countsketch.update(sk, keys[:, :n], vals[:, :n]).table
        t2 = countsketch.update(sk, keys[:, :n], vals[:, :n]).table
        assert _same_bits(t1, t2)


SAMPLER_NAMES = ["onepass", "perfect", "tv", "twopass"]


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_async_equals_sparse_bitwise_on_card(name, scheme):
    """Under the mode the async plane's drained state and sample equal the
    sparse plane's bit for bit on the card (the det scatter, PyTorch's
    deterministic sums), signed Zipf streams with deletions included."""
    _need_card()
    cfg = EngineConfig(num_streams=8, rows=7, width=2048, candidates=64,
                       capacity=64, sampler=name, scheme=scheme,
                       domain=1 << 16, num_samplers=3)
    stream = TurnstileZipfStream(vocab_size=1 << 16, alpha=1.2, seed=5)
    steps = [tuple(np.stack(x) for x in zip(*[
        stream.sparse_batch_at(t, b, 600) for b in range(8)]))
        for t in range(4)]
    with _deterministic():
        engs = []
        for plane in ("sparse", "async"):
            eng = SketchEngine(cfg, plane=plane, flush_elems=1000)
            before = ts.variant_launches["det"]
            for keys, vals in steps:
                eng.ingest(keys, vals)
            eng.flush()
            assert name == "perfect" or ts.variant_launches["det"] > before
            engs.append(eng)
        assert all(_same_bits(x, y) if x.is_floating_point()
                   else torch.equal(x, y)
                   for x, y in zip(_leaves(engs[0].state),
                                   _leaves(engs[1].state)))
        s1, s2 = engs[0].sample(8), engs[1].sample(8)
        assert torch.equal(s1.keys, s2.keys)
        assert _same_bits(s1.freqs, s2.freqs)
        engs[1].plane.close()


def _runs(rows, n, seed, hi):
    """Segment ids of stably sorted Zipf-like key rows, and values."""
    rng = np.random.default_rng(seed)
    keys = np.sort(np.minimum(rng.zipf(1.2, (rows, n)) - 1, hi), axis=1)
    first = np.ones((rows, n), bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    seg = torch.from_numpy(np.cumsum(first, 1) - 1)
    vals = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    return vals, seg


@pytest.mark.parametrize("rows,n,hi", [(4096, 5632, 2**20), (3, 1, 5),
                                       (5, 777, 0), (1, 100_000, 50),
                                       (64, 4096, 2**31), (7, 3000, 3),
                                       (3, 2500, 0), (300, 10, 4),
                                       (4, 1031, 6)])
def test_cuda_segment_sum_equals_cpu_bitwise(rows, n, hi):
    """The sorted segment sum adds each run in index order, as the CPU's
    scatter_add_ does: bit for bit equal to it, on every launch; a single
    run of all n slots (hi = 0) included, one longer than a 1024-slot tile
    (3, 2500, 0), runs that cross tiles (7, 3000, 3), short rows sharing a
    block (300, 10, 4) and rows of 4- and 8-byte copies (n = 1031)."""
    _need_card()
    vals, seg = _runs(rows, n, rows + n, hi)
    want = ref.segment_sum_ref(vals, seg)
    before = tseg.launches
    outs = [tseg.segment_sum(vals.cuda(), seg.cuda()).cpu() for _ in range(3)]
    assert tseg.launches == before + 3
    assert all(_same_bits(o, want) for o in outs)
    one = tseg.segment_sum(vals[0].cuda(), seg[0].cuda()).cpu()
    assert _same_bits(one, want[0])


def test_dedup_topc_on_card_equals_cpu_in_deterministic_mode():
    """Under the mode the card's buffer policy launches the segment sum
    and gives the CPU's keys, sums and priorities bit for bit."""
    _need_card()
    rng = np.random.default_rng(24)
    keys = torch.from_numpy(np.minimum(rng.zipf(1.2, (512, 5632)) - 1,
                                       2**20 - 1).astype(np.int32))
    keys[:, ::7] = -1
    vals = torch.from_numpy(rng.normal(size=(512, 5632)).astype(np.float32))
    prio = torch.from_numpy(rng.random((512, 5632)).astype(np.float32))
    want = worp._dedup_topc(keys, vals, prio, 512)
    before = tseg.launches
    with _deterministic():
        got = worp._dedup_topc(keys.cuda(), vals.cuda(), prio.cuda(), 512)
    assert tseg.launches == before + 1
    assert all(_same_bits(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("deterministic", [False, True])
def test_dedup_keys_topc_on_card_equals_cpu(deterministic):
    """The refresh's keys-only dedup launches no segment sum and gives the
    CPU's keys and priorities bit for bit in either mode, over -1 padding,
    duplicates, and -inf and NaN priorities; its keys are the valued
    dedup's."""
    _need_card()
    rng = np.random.default_rng(25)
    keys = torch.from_numpy(np.minimum(rng.zipf(1.2, (512, 5632)) - 1,
                                       2**20 - 1).astype(np.int32))
    keys[:, ::7] = -1
    prio = torch.from_numpy(rng.random(2**20).astype(np.float32))
    prio[rng.integers(0, 64, 8)] = float("nan")
    prio[rng.integers(0, 64, 8)] = float("-inf")
    prio = prio[keys.clamp(min=0).long()]
    want = worp._dedup_keys_topc(keys, prio, 512)
    assert torch.equal(want[0], worp._dedup_topc(
        keys, torch.zeros_like(prio), prio, 512)[0])
    before = tseg.launches
    with contextlib.ExitStack() as stack:
        if deterministic:
            stack.enter_context(_deterministic())
        got = worp._dedup_keys_topc(keys.cuda(), prio.cuda(), 512)
    assert tseg.launches == before
    assert all(_same_bits(g.cpu(), w) for g, w in zip(got, want))


def test_cuda_segment_sum_rejects_what_the_kernel_does_not_take():
    _need_card()
    vals, seg = _runs(2, 10, 0, 5)
    with pytest.raises(ValueError, match="int64"):
        tseg.segment_sum(vals.cuda(), seg.cuda().to(torch.int32))
    with pytest.raises(ValueError, match="float32"):
        tseg.segment_sum(vals.cuda().double(), seg.cuda())


# ---------------------------------------------------------------------------
# the conformance harness and the ingest pipeline on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["ingest", "async"])
def test_conformance_fast_cell_on_card(path):
    """A fast conformance cell (``onepass``, ppswor, p = 1) on the card:
    no check fails, and the trials went through the scatter and the
    estimate kernels."""
    _need_card()
    import threading

    from repro_torch.validate import conformance as C
    from repro_torch.validate import report

    before = (ts.launches, tq.estimate_launches)
    threads = threading.active_count()
    cfg = C.ConformanceConfig(trials=128, ref_trials=384, device="cuda")
    results = C.run_cell("onepass", "ppswor", 1.0, path, cfg)
    failed = [r for r in results if r.status == report.FAIL]
    assert not failed, "\n".join(f"{r.check}: {r.details}" for r in failed)
    assert any(r.status == report.PASS for r in results)
    assert ts.launches - before[0] >= cfg.chunks
    assert tq.estimate_launches - before[1] >= cfg.chunks + 1
    assert threading.active_count() <= threads


def test_fanin_async_equals_sparse_bitwise_on_card():
    """The feeder's fan-in into the async plane equals its fan-in into the
    sparse plane bit for bit under the deterministic mode."""
    _need_card()
    from repro_torch.data.ingest_pipeline import (PrefetchingFeeder,
                                                  ShardedSource)

    stream = TurnstileZipfStream(vocab_size=1 << 16, alpha=1.2, seed=3)
    cfg = EngineConfig(num_streams=64, rows=7, width=2048, candidates=64)
    with _deterministic():
        engs = []
        for plane in ("sparse", "async"):
            eng = SketchEngine(cfg, plane=plane, flush_elems=4096)
            PrefetchingFeeder(
                ShardedSource.from_turnstile(stream, 3000, num_shards=4,
                                             nsteps=6),
                eng, block_elems=2048, prefetch=2).run()
            engs.append(eng)
        assert all(_same_bits(x, y) if x.is_floating_point()
                   else torch.equal(x, y)
                   for x, y in zip(_leaves(engs[0].state),
                                   _leaves(engs[1].state)))
        s1, s2 = engs[0].sample(8), engs[1].sample(8)
        assert torch.equal(s1.keys, s2.keys)
        assert _same_bits(s1.freqs, s2.freqs)
        engs[1].plane.close()


def test_frequency_sketcher_kernel_path_on_card():
    """``FrequencySketcher.observe_signed(use_kernel=True)`` launches the
    scatter (B = 1) and the estimate kernels, and matches the plain path on
    the card: tables within the bound, the same candidates and sample.  The
    vocabulary (100 keys) is smaller than the buffer (128 candidates), so
    the buffer holds every key and no near tie at its cut decides it."""
    _need_card()
    from repro_torch.data.pipeline import FrequencySketcher

    kern, plain = (FrequencySketcher(k=32, rows=7, p=0.5, seed=19)
                   for _ in range(2))
    stream = TurnstileZipfStream(vocab_size=100, alpha=1.3, seed=8)
    before = (ts.launches, tq.estimate_single_launches)
    for step in range(5):
        k, v = stream.sparse_batch_at(step, 0, 5000)
        kern.observe_signed(k, v, use_kernel=True)
        plain.observe_signed(k, v)
    assert ts.launches - before[0] == 5
    assert tq.estimate_single_launches - before[1] == 5
    want = plain.state.sketch.table
    torch.testing.assert_close(kern.state.sketch.table, want, rtol=RTOL,
                               atol=_atol(want))
    assert torch.equal(torch.sort(kern.state.cand_keys).values,
                       torch.sort(plain.state.cand_keys).values)
    assert torch.equal(torch.sort(kern.sample().keys).values,
                       torch.sort(plain.sample().keys).values)


# ---------------------------------------------------------------------------
# the wire on the card: codecs, checkpoints, the fleet plane
# ---------------------------------------------------------------------------

def _wire_states(cfg, steps, plane="sparse", **opts):
    eng = SketchEngine(cfg, plane=plane, flush_elems=1000, plane_opts=opts)
    for keys, vals in steps:
        eng.ingest(keys, vals)
    eng.flush()
    return eng


def _wire_cfg_steps(name="onepass"):
    cfg = EngineConfig(num_streams=8, rows=7, width=2048, candidates=64,
                       capacity=64, sampler=name, domain=1 << 16,
                       num_samplers=3)
    stream = TurnstileZipfStream(vocab_size=1 << 16, alpha=1.2, seed=6)
    steps = [tuple(np.stack(x) for x in zip(*[
        stream.sparse_batch_at(t, b, 600) for b in range(8)]))
        for t in range(3)]
    return cfg, steps


@pytest.mark.parametrize("codec", ["fp16", "q8", "size_adaptive", "q2"])
def test_fake_quant_on_card_matches_host_grid(codec):
    """``fake_quant`` on the card: bit for bit the CPU's, and equal (``==``:
    a q grid's -0 decodes to +0 through int8) to the host byte codec's
    decode(encode), on the finite slices; a slice holding inf or NaN is
    left out."""
    _need_card()
    from repro_torch.distributed import codecs as wc

    cdc = wc.get_codec(codec)
    rng = np.random.default_rng(31)
    x = torch.from_numpy((rng.standard_t(3, (16, 7, 2048)) * 40).astype(
        np.float32))
    x[3, 2, 5], x[9, 0, 0] = float("inf"), float("nan")
    fin = x.isfinite().flatten(1).all(1)
    got = cdc.fake_quant(x.cuda()).cpu()
    host = torch.from_numpy(wc.decode_leaf(cdc.encode_leaf(x)))
    assert _same_bits(got[fin], cdc.fake_quant(x)[fin])
    assert torch.equal(got[fin], host[fin])


def test_codec_roundtrip_and_checkpoint_on_card(tmp_path):
    """A state on the card crosses the wire and a checkpoint back onto the
    card (``restore``'s default device), in its own dtypes: bit for bit
    under none (the next sample too), within the codec's bound under q8."""
    _need_card()
    from repro_torch.distributed import codecs as wc
    from repro_torch.train import checkpoint

    cfg, steps = _wire_cfg_steps()
    eng = _wire_states(cfg, steps)
    st = eng.state
    back = wc.get_codec("q8").roundtrip(st)
    for a, b in zip(_leaves(back), _leaves(st)):
        assert a.device == b.device and a.dtype == b.dtype
    wc.assert_trees_within_codec(back, st, "q8")
    for codec in ("none", "q8"):
        checkpoint.save(str(tmp_path / codec), 1, st, codec=codec)
        got = checkpoint.restore(str(tmp_path / codec), 1, st)
        assert all(x.is_cuda and x.dtype == y.dtype
                   for x, y in zip(_leaves(got), _leaves(st)))
        if codec == "q8":
            wc.assert_trees_within_codec(got, st, "q8")
            continue
        assert all(_same_bits(x, y) if x.is_floating_point()
                   else torch.equal(x, y)
                   for x, y in zip(_leaves(got), _leaves(st)))
        fresh = SketchEngine(cfg, flush_elems=1000)
        fresh.state = got
        assert torch.equal(fresh.sample(8).keys, eng.sample(8).keys)


@pytest.mark.parametrize("codec", ["none", "q8"])
def test_fleet_plane_on_card_equals_pipeline(codec):
    """The fleet plane at R = 2 on the card: state and sample bit for bit
    the pipeline's in the deterministic mode."""
    _need_card()
    cfg, steps = _wire_cfg_steps()
    with _deterministic():
        fleet = _wire_states(cfg, steps, "fleet", replicas=2, codec=codec)
        pipe = _wire_states(cfg, steps, "pipeline", shards=2, codec=codec)
        assert all(_same_bits(x, y) if x.is_floating_point()
                   else torch.equal(x, y)
                   for x, y in zip(_leaves(fleet.state), _leaves(pipe.state)))
        s1, s2 = fleet.sample(8), pipe.sample(8)
        assert torch.equal(s1.keys, s2.keys)
        assert _same_bits(s1.freqs, s2.freqs)
    fleet.plane.close()


# ---------------------------------------------------------------------------
# the multi-process fleet and gradient compression on the card
# ---------------------------------------------------------------------------

def _fleet_cfg(**kw):
    from repro_torch.distributed import fleet as F

    cfg, _ = _wire_cfg_steps()
    base = dict(engine=cfg, replicas=2, publish_every=2, ack_timeout=30.0,
                ping_timeout=10.0)
    base.update(kw)
    return F.FleetConfig(**base)


def test_fleet_coordinator_on_card_equals_fleet_plane_bitwise():
    """Two replica processes on the card, replica 1 killed after its 3rd
    block, in the deterministic mode (inherited across the spawn): the
    aggregated sample bit for bit the in-process fleet plane's, and the
    replicas report det scatter and estimate launches."""
    _need_card()
    from repro_torch.distributed import fleet as F

    fcfg = _fleet_cfg()
    _, steps = _wire_cfg_steps()
    blocks = [(k[:, i:i + 300], v[:, i:i + 300]) for k, v in steps
              for i in range(0, k.shape[1], 300)]
    with _deterministic():
        with F.FleetCoordinator(
                fcfg, faults={1: F.FaultPlan(kill_after=3)}) as co:
            for k, v in blocks:
                co.route(k, v)
            sample = co.sample(8)
            info, stats = co.replica_info, co.stats
        ref = F.reference_sample(fcfg.engine, blocks, 2, 8)
    assert stats.restarts == 1
    assert all(i["deterministic"] and i["device"].startswith("cuda")
               for i in info)
    assert torch.equal(sample.keys, ref.keys)
    assert _same_bits(sample.freqs, ref.freqs)
    got = stats.replica_launches
    assert got["det"] > 0 and got["estimate"] > 0 and got["smem"] == 0


def test_fleet_replica_inherits_the_deterministic_mode():
    """A spawned replica starts with the parent's mode: off by default
    (its scatters take the shared-memory atomics), on under the switch
    (the det variant).  Its one-pass refresh sums nothing in either mode:
    no segment sum."""
    _need_card()
    from repro_torch.distributed import fleet as F

    _, steps = _wire_cfg_steps()
    for on in (False, True):
        with contextlib.ExitStack() as stack:
            if on:
                stack.enter_context(_deterministic())
            with F.FleetCoordinator(_fleet_cfg(replicas=1)) as co:
                assert co.replica_info[0]["deterministic"] is on
                co.route(*steps[0])
                co.merged_state()
                got = dict(co.stats.replica_launches)
        assert (got["det"] > 0) is on and (got["smem"] > 0) is not on
        assert got["segment_sum"] == 0


def test_tree_compress_step_engine_on_card():
    """One launch of the dense update kernel and one of the estimate per
    engine call, over a one-rank NCCL group; two-pass values exact,
    ``sparse + err == a`` bit for bit, every leaf represented, and the ids
    of the CPU's plain path on well-separated gradients."""
    _need_card()
    import tempfile

    import torch.distributed as dist
    from repro_torch.optim import gradcomp as G

    rng = np.random.default_rng(31)
    host = {"w": rng.normal(size=(256, 64)).astype(np.float32),
            "v": rng.normal(size=5000).astype(np.float32),
            "b": rng.normal(size=40).astype(np.float32)}
    for i, x in enumerate(host.values()):
        x.reshape(-1)[: 8] = (np.arange(8) + 1.0) * (100.0 + 10 * i)
    cc = G.CompressorConfig(k=32, rows=7, width=2048, mode="twopass")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            dev = {k: torch.tensor(v, device="cuda") for k, v in host.items()}
            u0, e0 = tu.launches, tq.estimate_launches
            sparse, err, stats = G.tree_compress_step_engine(
                dev, G.init_error(dev), cc, k_per_leaf=8)
            torch.cuda.synchronize()
            assert (tu.launches - u0, tq.estimate_launches - e0) == (1, 1)
        finally:
            dist.destroy_process_group()
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store_cpu"), 1), rank=0, world_size=1)
        try:
            cpu = {k: torch.tensor(v) for k, v in host.items()}
            want, _, _ = G.tree_compress_step_engine(
                cpu, G.init_error(cpu), cc, k_per_leaf=8)
        finally:
            dist.destroy_process_group()
    for k, a in dev.items():
        nz = torch.nonzero(sparse[k].ravel()).ravel()
        assert 1 <= len(nz) <= 8
        assert _same_bits(sparse[k].ravel()[nz], a.ravel()[nz])
        assert _same_bits(sparse[k] + err[k], a)
        assert torch.equal(torch.nonzero(sparse[k].cpu()),
                           torch.nonzero(want[k]))
    assert stats["tau"].shape == (3,)


# ---------------------------------------------------------------------------
# the dense model family on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma2_2b", "phi4_mini_38b"])
def test_dense_model_decode_matches_forward_on_card(name):
    """Reduced, float32, TF32 off: prefill 32 tokens and decode token 32 on
    the card against the teacher-forced forward at position 32 (the
    reference test's 0.1 of max|logit|), and the card's forward against
    the CPU's (rtol 1e-4, atol 1e-3 x max(1, max|logit|))."""
    _need_card()
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(name).reduced()
        host = M.init_params(cfg, torch.Generator().manual_seed(2),
                             dtype=torch.float32)
        params = convert.params_from_numpy(convert.params_to_numpy(host),
                                           "cuda")
        toks = torch.randint(0, cfg.vocab_size, (1, 33), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            full = T.forward_train(params, {"tokens": toks.cuda()}, cfg)
            want = T.forward_train(host, {"tokens": toks}, cfg)
            _, cache = T.forward_prefill(params, {"tokens": toks[:, :32]
                                                  .cuda()}, cfg)
            cache = serve.grow_cache(cache, 32, 33)
            lg, _ = T.forward_decode(params, {"token": toks[:, 32:].cuda(),
                                              "pos": 32, "cache": cache},
                                     cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    full, lg = full.cpu(), lg.cpu()
    scale = max(1.0, float(want.abs().max()))
    assert torch.allclose(full, want, rtol=1e-4, atol=1e-3 * scale)
    got, ref_row = lg[:, 0], full[:, 32]
    assert float((got - ref_row).abs().max()) / (
        float(ref_row.abs().max()) + 1e-6) < 0.1


# ---------------------------------------------------------------------------
# the moe, ssm, hybrid, enc-dec and vlm families on the card
# ---------------------------------------------------------------------------

NEW_FAMILIES = ("olmoe_1b_7b", "grok1_314b", "mamba2_13b",
                "recurrentgemma_9b", "seamless_m4t_large_v2",
                "phi3_vision_42b")


def _family_batch(cfg, toks, gen):
    """``toks`` and the vlm's patch embeddings or the enc-dec's frames
    (N(0, 1) x 0.02, from ``gen``), on the CPU."""
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (toks.shape[0], cfg.num_patches, cfg.d_model),
            generator=gen) * 0.02
    elif cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (toks.shape[0], cfg.enc_context, cfg.d_model),
            generator=gen) * 0.02
    return batch


def _to(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_family_on_card_matches_cpu(name):
    """Reduced, float32, TF32 off: the forward, the prefill and 4 greedy
    decode steps on the card against the port's CPU path with the same
    weights (rtol 1e-4, atol 1e-3 x max(1, max|logit|); seamless 1e-2 x:
    its random cross-attention amplifies float32 rounding 70-fold,
    tests/test_torch_models.py), and decode from a 32-token prefill
    against the card's forward at position 32 (the reference test's 0.1 of
    max|logit|; the vlm's position after its patches)."""
    _need_card()
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = get_config(name).reduced()
    scale_f = 1e-2 if cfg.family == "encdec" else 1e-3
    P = cfg.num_patches if cfg.family == "vlm" else 0
    gen = torch.Generator().manual_seed(5)
    host = M.init_params(cfg, gen, dtype=torch.float32)
    params = convert.params_from_numpy(convert.params_to_numpy(host), "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 33), dtype=torch.int32,
                         generator=gen)
    full_b = _family_batch(cfg, toks, torch.Generator().manual_seed(6))
    pre_b = dict(full_b, tokens=toks[:, :32])

    def close(got, want):
        got, want = got.cpu(), want.cpu()
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=scale_f * scale)

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            full = T.forward_train(params, _to(full_b, "cuda"), cfg)
            close(full, T.forward_train(host, full_b, cfg))
            lg, cache = T.forward_prefill(params, _to(pre_b, "cuda"), cfg)
            hl, hcache = T.forward_prefill(host, pre_b, cfg)
            close(lg, hl)
            # a cache of its own: decode updates the states in place
            _, first = T.forward_prefill(params, _to(pre_b, "cuda"), cfg)
            first = serve.grow_cache(first, 32, 33 + P, P)
            dl, _ = T.forward_decode(params, {"token": toks[:, 32:].cuda(),
                                              "pos": 32 + P,
                                              "cache": first}, cfg)
            want = full[:, 32 + P]
            assert float((dl[:, 0] - want).abs().max()) / (
                float(want.abs().max()) + 1e-6) < 0.1
            cache = serve.grow_cache(cache, 32, 36 + P, P)
            hcache = serve.grow_cache(hcache, 32, 36 + P, P)
            tok = serve.greedy(lg[:, -1:])
            for i in range(4):
                lg, cache = T.forward_decode(params, {
                    "token": tok, "pos": 32 + P + i, "cache": cache}, cfg)
                hl, hcache = T.forward_decode(host, {
                    "token": tok.cpu(), "pos": 32 + P + i, "cache": hcache},
                    cfg)
                close(lg, hl)
                tok = serve.greedy(lg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_mamba2_prefill_in_the_deterministic_mode():
    """The reduced mamba2's prefill in the deterministic mode: SSD's float
    ``cumsum`` and its products run there without raising, two runs give
    the same bits, within the CPU's tolerance of the default mode's logits
    and caches."""
    _need_card()
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2_13b").reduced()
    host = M.init_params(cfg, torch.Generator().manual_seed(7),
                         dtype=torch.float32)
    params = convert.params_from_numpy(convert.params_to_numpy(host), "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 256), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(8)).cuda()
    with torch.no_grad():
        want, wcache = T.forward_prefill(params, {"tokens": toks}, cfg)
        with _deterministic():
            runs = [T.forward_prefill(params, {"tokens": toks}, cfg)
                    for _ in range(2)]
    (a, ca), (b, cb) = runs
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(
        (ca["layers"]["ssm"], ca["layers"]["conv"]),
        (cb["layers"]["ssm"], cb["layers"]["conv"])))
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-3 * scale)
    torch.testing.assert_close(ca["layers"]["ssm"], wcache["layers"]["ssm"],
                               rtol=1e-4, atol=1e-3 * max(
                                   1.0, float(wcache["layers"]["ssm"].abs()
                                              .max())))


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "mamba2_13b",
                                  "recurrentgemma_9b", "phi3_vision_42b"])
def test_serve_main_of_each_family_launches_the_analytics_kernels(name):
    """``serve.main`` reduced on the card (its defaults: batch 4, a
    64-token prompt, 16 tokens) with --worp-topk 5: the analytics' flushes
    launch the scatter and the estimate kernels."""
    _need_card()
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    before = (ts.launches, tq.estimate_launches)
    out = serve.main(["--arch", name, "--reduced", "--worp-topk", "5"])
    assert ts.launches > before[0] and tq.estimate_launches > before[1]
    assert out.gen.ids.shape == (4, 17)
    assert out.gen.ids.max() < get_config(name).reduced().padded_vocab()
    assert out.sample.keys.device.type == "cuda"


# the training cells: AdamW at the loop's default lr moves an element by at
# most ~lr a step, so three steps from the same weights stay within
# 1e-3 x max(1, max|want|) of the CPU's even where a gradient of rounding
# size flips a step's sign (the serve pairs' scale-aware tolerance).  The
# moments hold the gradients themselves, which the reduced random attention
# models' near-tie softmaxes make sensitive to the summation order: a few
# elements of phi4_mini's differed by 1.7e-2 of their leaf's max between
# the card and the CPU (3 of 262,144), hence 5e-2
TRAIN_LR, TRAIN_STEPS, TRAIN_ATOL, TRAIN_MOMENTS = 3e-4, 3, 1e-3, 5e-2


@pytest.mark.parametrize("name", ["phi4_mini_38b", "mamba2_13b",
                                  "olmoe_1b_7b"])
def test_train_step_on_card_matches_cpu(name):
    """Three ``train_step``s of a reduced float32 model, TF32 off, on the
    card and on the CPU from the same weights and batches: losses within
    1e-3 x max(1, |want|), every parameter leaf within 1e-3 x max(1,
    max|want|), the moments within 5e-2 x their leaf's max|want|."""
    _need_card()
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import ZipfStream
    from repro_torch.distributed import pytree
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = get_config(name).reduced()
    host = M.init_params(cfg, torch.Generator().manual_seed(3),
                         dtype=torch.float32)
    card = convert.params_from_numpy(convert.params_to_numpy(host), "cuda")
    hs = steps.TrainState(host, adamw.init(host))
    cs = steps.TrainState(card, adamw.init(card))
    stream = ZipfStream(cfg.vocab_size, 1.2, 0)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(TRAIN_STEPS):
            hb = stream.lm_batch(i, 0, 2, 32, device="cpu")
            cs, cm = steps.train_step(cs, {k: v.cuda() for k, v in
                                           hb.items()}, cfg, lr=TRAIN_LR)
            hs, hm = steps.train_step(hs, hb, cfg, lr=TRAIN_LR)
            want = float(hm["loss"])
            assert abs(float(cm["loss"]) - want) <= TRAIN_ATOL * max(
                1.0, abs(want))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    for got_tree, want_tree, scale in (
            (cs.params, hs.params, None),
            (cs.opt.mu, hs.opt.mu, TRAIN_MOMENTS),
            (cs.opt.nu, hs.opt.nu, TRAIN_MOMENTS)):
        for (path, got), want in zip(pytree.leaves_with_path(got_tree),
                                     pytree.leaves(want_tree)):
            top = float(want.abs().max())
            atol = TRAIN_ATOL * max(1.0, top) if scale is None \
                else scale * max(top, 1e-30)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol,
                                       msg=lambda m, p=path: f"{p}: {m}")


def test_training_restart_in_the_deterministic_mode_bitwise(tmp_path):
    """The reduced mamba2's training loop on the card in the deterministic
    mode: two uninterrupted 8-step runs give the same losses and weights
    bit for bit, and 4 steps plus a resume of 4 from the checkpoint give
    the uninterrupted run's."""
    _need_card()
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import pytree
    from repro_torch.train import loop

    cfg = get_config("mamba2_13b").reduced()
    kw = dict(batch=2, seq=32, lr=1e-3, log_every=100,
              print_fn=lambda s: None)
    d = str(tmp_path / "ck")
    with _deterministic():
        a = loop.run_training(cfg, num_steps=8, **kw)
        b = loop.run_training(cfg, num_steps=8, **kw)
        loop.run_training(cfg, num_steps=4, ckpt_dir=d, ckpt_every=100,
                          **kw)
        r = loop.run_training(cfg, num_steps=8, ckpt_dir=d, ckpt_every=100,
                              **kw)
    assert a["losses"] == b["losses"] and r["losses"] == a["losses"][4:]
    for x, y, z in zip(*(pytree.leaves(o["state"]) for o in (a, b, r))):
        assert x.device.type == "cuda"
        assert torch.equal(x, y) and torch.equal(x, z)


def test_train_cli_with_analytics_kernels_on_card():
    """``launch.train.main`` reduced on the card, plain and compressed (a
    one-rank NCCL group it builds and tears down), and the loop's token
    analytics launching the scatter and estimate kernels."""
    _need_card()
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop

    for extra in ([], ["--compressed"]):
        out = launch_train.main(["--arch", "mamba2_13b", "--reduced",
                                 "--steps", "2", "--batch", "2", "--seq",
                                 "32"] + extra)
        assert np.isfinite(out["losses"]).all()
        assert not dist.is_initialized()
    before = (ts.launches, tq.estimate_launches)
    out = loop.run_training(get_config("phi4_mini_38b").reduced(),
                            num_steps=2, batch=2, seq=32, log_every=100,
                            print_fn=lambda s: None,
                            analytics_sampler="onepass", analytics_topk=8)
    assert ts.launches > before[0] and tq.estimate_launches > before[1]
    assert len(out["top_tokens"]) == 8


# ---------------------------------------------------------------------------
# packed streams (the engine compressor's leaves, back to back)
# ---------------------------------------------------------------------------

PACKED_SIZES = [5, 70_000, 1, 300, 33_000, 0, 2047]


@pytest.mark.parametrize("variant", ["smem", "global", "det"])
def test_cuda_packed_update_equals_the_padded_rows(variant):
    """Streams packed back to back with device offsets: the same delta as
    the streams padded into rows (the det variant the same bits; the
    atomic variants within the plain version's bounds)."""
    _need_card()
    sizes = PACKED_SIZES
    g = torch.Generator().manual_seed(11)
    packed = torch.randn(sum(sizes), generator=g)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    rows_ = torch.zeros((len(sizes), max(sizes)))
    for b, (o, n) in enumerate(zip(offsets, sizes)):
        rows_[b, :n] = packed[o:o + n]
    seeds = torch.randint(0, 2**32, (len(sizes),), generator=g)
    kw = dict(p=1.0, transform_seeds=seeds.cuda() * 3 % 2**32,
              lengths=sizes)
    det = variant == "det"
    with (_deterministic() if det else contextlib.nullcontext()):
        got = tu.countsketch_update_batched(
            packed.cuda(), 7, 2048, seeds.cuda(), offsets=torch.from_numpy(
                offsets).cuda(), _variant=None if det else variant, **kw)
        padded = tu.countsketch_update_batched(
            rows_.cuda(), 7, 2048, seeds.cuda(),
            _variant=None if det else variant, **kw)
    if det:
        assert torch.equal(got, padded)
    else:
        plain = dict(p=1.0, transform_seeds=seeds * 3 % 2**32,
                     lengths=sizes)
        want = ref.countsketch_update_batched_ref(rows_, 7, 2048, seeds,
                                                  **plain)
        mass = ref.countsketch_update_mass_ref(rows_, 7, 2048, seeds,
                                               **plain)
        _check_sum(got.cpu(), want, mass)
        _check_sum(padded.cpu(), want, mass)
    assert not got[sizes.index(0)].any()


def test_engine_compressed_step_on_card_matches_the_padded_step():
    """The engine compressor on the card in the deterministic mode: the
    packed leaves give the padded block's update and error bit for bit
    (tests/test_torch_gradcomp_packed.py's oracle), over one-rank NCCL."""
    _need_card()
    import tempfile

    import torch.distributed as dist
    from repro_torch.optim import gradcomp as G
    from test_torch_gradcomp_packed import _tree, padded_step

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            device_id=torch.device("cuda", 0))
        try:
            cc = G.CompressorConfig(rows=7, width=2048, seed=5)
            grads = {k: v.cuda() for k, v in _tree(0).items()}
            err = G.init_error(grads)
            with _deterministic():
                sp, ne, _ = G.tree_compress_step_engine(grads, err, cc)
                psp, perr, _ = padded_step(grads, err, cc)
            for k in grads:
                assert torch.equal(sp[k], psp[k]) and torch.equal(
                    ne[k], perr[k]), k
        finally:
            dist.destroy_process_group()


def test_hybrid_moe_on_card_matches_the_reference():
    """granite-4.0-h's family reduced, float32 with TF32 off, on the card:
    the loss and every gradient within 1e-3 of the plain reference's
    (tests/granite_hybrid_ref.py; SDPA's kernel and the atomics of the
    expert scatter sum in other orders), no choice dropped, and the
    engine-compressed step runs over a one-rank NCCL group."""
    _need_card()
    import dataclasses
    import tempfile

    import torch.distributed as dist
    from granite_hybrid_ref import Reference, hf_config
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import pytree
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import adamw, gradcomp
    from repro_torch.train import steps

    cfg = get_config("granite_4_0_h_small").reduced()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = pytree.tree_map(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=g,
                                        device="cuda"),
        M.init_params(cfg, g, dtype=torch.float32))
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=g,
                         device="cuda")
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with moe.count_drops() as drops:
            loss, grads = steps.value_and_grad(params, b, cfg)
        want, wgrads = Reference(hf_config(cfg)).loss_and_grads(
            params, b["tokens"], b["labels"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert abs(float(loss) - float(want)) <= 1e-3 * abs(float(want))
    for got, w in zip(pytree.leaves(grads), pytree.leaves(wgrads)):
        assert float((got - w).abs().max()) <= 1e-3 * float(
            w.abs().max().clamp_min(1e-30))
    assert sum(int(d) for d, _ in drops) == 0
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            device_id=torch.device("cuda", 0))
        try:
            bf = dataclasses.replace(cfg)
            p16 = pytree.tree_map(lambda t: t.to(torch.bfloat16), params)
            st = steps.CompressedTrainState(p16, adamw.init(p16),
                                            gradcomp.init_error(p16))
            step = steps.make_compressed_train_step_engine(
                bf, None, gradcomp.CompressorConfig())
            launches = tu.launches
            for _ in range(2):
                st, m = step(st, b)
            assert tu.launches == launches + 2
            assert bool(torch.isfinite(m["loss"]))
        finally:
            dist.destroy_process_group()


def test_moe_held_on_card_matches_per_expert_products_in_bfloat16():
    """The held experts' grouped products in bfloat16 on the card, output
    and gradients, against each expert's products in float32 over its own
    tokens: within bfloat16's rounding (2e-2 of each tensor's largest),
    and finite where the grouped products leave rows unwritten."""
    _need_card()
    from repro_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(5)
    T, D, F_, E, held, K, off = 4096, 256, 96, 18, 4, 6, 4
    x = torch.randn(1, T, D, generator=g, device="cuda")
    mp = {"router": torch.randn(D, E, generator=g, device="cuda"),
          "wg": torch.randn(held, D, F_, generator=g, device="cuda") / 16,
          "wi": torch.randn(held, D, F_, generator=g, device="cuda") / 16,
          "wo": torch.randn(held, F_, D, generator=g, device="cuda") / 10}
    dy = torch.randn(1, T, D, generator=g, device="cuda")

    def grads(fn, dtype):
        xs = x.to(dtype).requires_grad_(True)
        ws = {k: v.to(dtype).requires_grad_(True) for k, v in mp.items()}
        out = fn(xs, ws)
        out.backward(dy.to(dtype))
        return [out] + [xs.grad] + [ws[k].grad for k in ("wg", "wi", "wo")]

    def plain(xs, ws):
        xt = xs.reshape(T, D).float()
        logits = xt @ ws["router"].float()
        top, idx = torch.topk(logits, K, dim=-1)
        gates = torch.softmax(top, -1)
        out = torch.zeros_like(xt)
        for e in range(held):
            tok, slot = torch.nonzero(idx == off + e, as_tuple=True)
            h = xt[tok]
            a = torch.nn.functional.silu(h @ ws["wg"][e].float()) \
                * (h @ ws["wi"][e].float())
            out = out.index_add(0, tok, (a @ ws["wo"][e].float())
                                * gates[tok, slot][:, None])
        return out.reshape(1, T, D)

    got = grads(lambda xs, ws: moe.moe_held(xs, ws, K, off, held),
                torch.bfloat16)
    want = grads(plain, torch.float32)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b).abs().max()) <= 2e-2 * float(
            b.abs().max())
