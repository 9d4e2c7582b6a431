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
"""
import numpy as np
import pytest
import torch

from repro_torch.core import countsketch, hashing, worp
from repro_torch.core.sampler import SamplerConfig, make_sampler
from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import countsketch_scatter as ts
from repro_torch.kernels import countsketch_update as tu
from repro_torch.kernels import ppswor_transform as tt
from repro_torch.kernels import ref, tiling

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
