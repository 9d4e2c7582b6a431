"""``tree_compress_step_engine`` packs the leaves back to back: its results
equal, bit for bit, those of the leaves padded into an (L, n_max) block,
the design it replaced, kept here as the oracle (``padded_step``).

Trees are ragged and hold a leaf shorter than ``cand_per_leaf`` (whose
padded slots are among its candidates), ties at the candidates' cut and
bfloat16 gradients; each runs over a one-rank gloo group on the CPU, in
both modes, over two steps with the error carried."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import countsketch, worp
from repro_torch.distributed import codecs as wire_codecs
from repro_torch.distributed import pytree
from repro_torch.engine import engine as E
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.optim import gradcomp as G


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def padded_step(grads, error, cc, group=None, k_per_leaf=32,
                cand_per_leaf=64):
    """The engine step with every leaf padded to the largest (the step as
    it was before the leaves were packed), one worker."""
    leaves_g, leaves_e = pytree.leaves(grads), pytree.leaves(error)
    sizes = [x.numel() for x in leaves_g]
    L, n_max = len(leaves_g), max(sizes)
    dev = leaves_g[0].device
    accs = [g.to(torch.float32).reshape(-1) + e.reshape(-1)
            for g, e in zip(leaves_g, leaves_e)]
    a_pad = torch.zeros((L, n_max), dtype=torch.float32, device=dev)
    for li, a in enumerate(accs):
        a_pad[li, :sizes[li]] = a
    t_seeds = torch.tensor([int(G._leaf_salt(cc, li)) for li in range(L)],
                           dtype=torch.int64, device=dev)
    sk_seeds = t_seeds ^ 1
    tables = kernel_ops.sketch_dense_batch(
        a_pad, cc.rows, cc.width, sk_seeds, p=cc.p, scheme=cc.scheme,
        transform_seeds=t_seeds, lengths=np.asarray(sizes, np.int32))
    tables = wire_codecs.fake_quant(tables, cc.codec)
    ncand = min(cand_per_leaf, n_max)
    _, cand = worp.top_k(torch.abs(a_pad), ncand)
    cand = cand.to(torch.int32)
    k_leaf = min(k_per_leaf, cand.shape[1] - 1)
    si = torch.sort(cand, dim=1, stable=True).values
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    state = worp.OnePassState(
        sketch=countsketch.CountSketch(table=tables, seed=sk_seeds),
        cand_keys=torch.where(dup, -1, si).to(torch.int32),
        seed_transform=t_seeds)
    s = E.onepass_sample_batched(state, k_leaf, cc.p, cc.scheme)
    sel, est_vals = s.keys, s.freqs
    live = sel != -1
    if cc.mode == "twopass":
        exact = torch.gather(a_pad, 1, torch.where(live, sel, 0).to(
            torch.int64))
        vals = torch.where(live, exact, 0.0) / 1.0
    else:
        vals = torch.where(live, est_vals, 0.0) / 1.0
    sparse, err = [], []
    for li, (a, size, g) in enumerate(zip(accs, sizes, leaves_g)):
        hit = live[li] & (sel[li] < size)
        safe = torch.where(hit, sel[li], size).to(torch.int64)
        sp = torch.zeros((size + 1,), dtype=torch.float32, device=dev)
        sp[safe] = torch.where(hit, vals[li], 0.0)
        sp = sp[:size]
        sparse.append(sp.reshape(g.shape))
        err.append(torch.where(sp != 0.0, 0.0, a).reshape(g.shape))
    return (pytree.unflatten(grads, sparse), pytree.unflatten(grads, err),
            s.threshold)


def _tree(seed, dtype=torch.float32):
    """Ragged leaves: one shorter than cand_per_leaf, one of ties (a block
    of equal magnitudes across the candidates' cut, zeros), a wide one."""
    g = torch.Generator().manual_seed(seed)
    ties = torch.zeros(700)
    ties[100:400] = 3.0
    ties[400:450] = -3.0
    return {"a_short": torch.randn(40, generator=g).to(dtype),
            "b_ties": ties.to(dtype),
            "c_wide": (torch.randn(96, 130, generator=g)
                       * torch.exp(1.5 * torch.randn(96, 130,
                                                     generator=g))).to(dtype),
            "d_mid": torch.randn(5, 301, generator=g).to(dtype)}


def _bits(x):
    return x.dtype, tuple(x.shape), x.contiguous().view(torch.uint8) \
        .numpy().tobytes() if x.dtype != torch.bfloat16 else \
        x.view(torch.int16).numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["twopass", "onepass"])
def test_packed_equals_padded_bit_for_bit(group, mode, dtype):
    cc = G.CompressorConfig(rows=5, width=256, p=1.0, mode=mode, seed=77)
    error = {k: torch.zeros(v.shape) for k, v in _tree(0).items()}
    padded_err = dict(error)
    for step in range(2):
        grads = _tree(step, dtype)
        sp, err, stats = G.tree_compress_step_engine(
            grads, error, cc, group, k_per_leaf=32, cand_per_leaf=64)
        psp, perr, tau = padded_step(grads, padded_err, cc, k_per_leaf=32,
                                     cand_per_leaf=64)
        for k in grads:
            assert _bits(sp[k]) == _bits(psp[k]), (step, k)
            assert _bits(err[k]) == _bits(perr[k]), (step, k)
        assert torch.equal(stats["tau"], tau)
        # the short leaf's padded slots are among the candidates: its whole
        # length is sampled (k_per_leaf = 32 of its 40) or cut at the pad
        assert int((sp["a_short"] != 0).sum()) <= 32
        error, padded_err = err, perr


@pytest.mark.parametrize("n,k", [(1, 1), (64, 64), (700, 64), (5000, 37)])
def test_top_ids_is_the_stable_sorts_set(monkeypatch, n, k):
    """The keyed top-k keeps exactly the stable sort's first k indices,
    ties to the lower index, chunk by chunk as one pass."""
    monkeypatch.setattr(G, "_RANK_CHUNK", 256)
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-3, 4, (n,), generator=g).to(torch.float32)
    x[n // 3:] *= torch.rand(n - n // 3, generator=g).round()
    if n > 10:
        x[5] = float("nan")
    want = torch.sort(x.abs(), descending=True, stable=True).indices[:k]
    got = G._top_ids(x, k)
    assert sorted(got.tolist()) == sorted(want.tolist())


def test_packed_reference_equals_the_padded_rows_bit_for_bit():
    """The kernel layer's packed entry on the CPU: each stream's table as
    the streams padded into rows give it."""
    g = torch.Generator().manual_seed(3)
    sizes = [5, 300, 1, 77]
    packed = torch.randn(sum(sizes), generator=g)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])])
    rows = torch.zeros((len(sizes), max(sizes)))
    for b, (o, n) in enumerate(zip(offsets, sizes)):
        rows[b, :n] = packed[o:o + n]
    seeds = torch.tensor([11, 12, 13, 14])
    kw = dict(p=1.0, transform_seeds=seeds * 3)
    got = kernel_ops.sketch_dense_batch(packed, 5, 64, seeds, lengths=sizes,
                                        offsets=offsets, **kw)
    want = ref.countsketch_update_batched_ref(rows, 5, 64, seeds,
                                              lengths=sizes, **kw)
    assert torch.equal(got, want)
