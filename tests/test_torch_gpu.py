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
give the same bits too.
"""
import contextlib

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
    rounding bound of the plain version (stages of 1024 slots: 2500 slots
    make three)."""
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


def test_cuda_det_scatter_table_too_large_raises():
    """No deterministic variant for a table past a block's shared memory:
    the mode raises, naming the shape, and launches nothing."""
    _need_card()
    keys, vals, seeds, tseeds = _streams(2, 300, seed=22)
    before = ts.launches
    with _deterministic(), pytest.raises(ValueError,
                                         match="deterministic mode.*7 x "
                                               "16384"):
        ts.countsketch_scatter_batched(keys.cuda(), vals.cuda(), 7, 16384,
                                       seeds.cuda(), p=1.0,
                                       transform_seeds=tseeds.cuda())
    assert ts.launches == before


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


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
                                       (64, 4096, 2**31)])
def test_cuda_segment_sum_equals_cpu_bitwise(rows, n, hi):
    """The sorted segment sum adds each run in index order, as the CPU's
    scatter_add_ does: bit for bit equal to it, on every launch; a single
    run of all n slots (hi = 0) included."""
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
