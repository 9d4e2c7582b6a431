"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips, inside its body, when no card
is present: a CUDA kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the query reads one float and multiplies it by +-1, so it must
be bit for bit.  The scatter and the dense update sum many transformed
values per bucket with float atomics, whose order varies from run to run,
and their fused -log/pow may differ from PyTorch's by a few ulps, so they
are held to the reference's scale-aware bound, rtol 1e-4 and atol 1e-5 *
max(1, max|want|), and, cell by cell, to the float32 rounding bound of their
own terms (``ref.scatter_tolerance``).  The standalone transform is held to
the tolerances of tests/test_kernels.py: rtol 1e-5 / atol 1e-6 in float32,
rtol 2e-2 / atol 1e-2 in bfloat16 (one rounding of the factor may flip).
"""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import countsketch_scatter as ts
from repro_torch.kernels import countsketch_update as tu
from repro_torch.kernels import ppswor_transform as tt
from repro_torch.kernels import ref

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


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_cuda_scatter_matches_plain(case):
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
    before = ts.launches
    got = ts.countsketch_scatter_batched(
        keys.cuda(), vals.cuda(), 6, 1000, seeds.cuda(),
        transform_seeds=tseeds.cuda(),
        lengths=None if lengths is None else lengths.cuda(), **opts).cpu()
    assert ts.launches == before + 1
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
    before = (ts.launches, tq.launches)
    for t in range(3):
        batches = [stream.sparse_batch_at(t, b, 256) for b in range(4)]
        keys = np.stack([k for k, _ in batches])
        vals = np.stack([v for _, v in batches])
        card.ingest(keys, vals)
        cpu.ingest(keys, vals)
    card_sample = card.sample(16)
    assert ts.launches == before[0] + 3
    assert tq.launches >= before[1] + 4
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


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_cuda_update_matches_plain(case):
    _need_card()
    B, n, rows, width, opts = UPDATE_CASES[case]
    _, vals, seeds, tseeds = _streams(B, n, seed=5)
    kw = _dense_opts(opts, "cpu")
    want = ref.countsketch_update_batched_ref(vals, rows, width, seeds,
                                              transform_seeds=tseeds, **kw)
    before = tu.launches
    got = tu.countsketch_update_batched(
        vals.cuda(), rows, width, seeds.cuda(), transform_seeds=tseeds.cuda(),
        **_dense_opts(opts, "cuda")).cpu()
    assert tu.launches == before + 1
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
    before = (tq.launches, tq.single_launches)
    rows = tq.countsketch_query(want.cuda(), keys.cuda(), seed).cpu()
    est = tq.countsketch_estimate(want.cuda(), keys.cuda(), seed).cpu()
    assert (tq.launches, tq.single_launches) == (before[0], before[1] + 2)
    assert torch.equal(rows, ref.countsketch_query_ref(want, keys, seed))
    assert torch.equal(est, ref.countsketch_estimate_ref(want, keys, seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_transform_matches_plain(dtype):
    _need_card()
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, 100_000).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=100_000).astype(np.float32)).to(
        getattr(torch, dtype))
    before = tt.launches
    for p in (0.5, 1.0, 2.0):
        want = ref.ppswor_transform_ref(keys, vals, p, 2**32 - 3)
        got = tt.ppswor_transform(keys.cuda(), vals.cuda(), p,
                                  2**32 - 3).cpu()
        assert got.dtype == vals.dtype
        bf16 = dtype == "bfloat16"
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2e-2 if bf16 else 1e-5,
                                   atol=1e-2 if bf16 else 1e-6)
    assert tt.launches == before + 3


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
    before = (tu.launches, tq.launches)
    for _ in range(3):
        vals = (rng.normal(size=(3, 2000))
                * np.exp(1.5 * rng.normal(size=(3, 2000)))).astype(np.float32)
        card.update_dense(vals, base_keys=base, lengths=lengths)
        cpu.update_dense(vals, base_keys=base, lengths=lengths)
    card_sample = card.sample(16)
    assert tu.launches == before[0] + 3
    assert tq.launches >= before[1] + 4
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
