"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips, inside its body, when no card
is present: a CUDA kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it also runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the query reads one float and multiplies it by +-1, so it must
be bit for bit.  The scatter sums many transformed values per bucket with
float atomics, whose order varies from run to run, and its fused -log/pow
may differ from PyTorch's by a few ulps, so it is held to the reference's
scale-aware bound, rtol 1e-4 and atol 1e-5 * max(1, max|want|), and, cell by
cell, to the float32 rounding bound of its own terms
(``ref.scatter_tolerance``).
"""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import countsketch_scatter as ts
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
