"""The port's WORp gradient compression and AdamW
(``repro_torch.optim.gradcomp``, ``repro_torch.optim.adamw``) against the
JAX package's, on the CPU.

The JAX functions run under ``jax.jit(shard_map(...))`` over a ``(1,)``
mesh, as ``tests/test_distributed.py`` and ``tests/test_engine.py`` run
them (the engine path's Pallas kernels in interpret mode); the port's run
over a one-rank gloo group (a ``FileStore`` under the test's ``tmp_path``),
the same inputs made with numpy from a seed.  Tolerances:

* sampled ids, the supports of ``sparse`` and ``err``, ``_leaf_salt``, the
  fused (leaf, id) key, the static stats (``comm_bytes`` under every
  codec) and the two-pass values: bit for bit (the two-pass value is the
  accumulated gradient read at the id, the same bits in both packages);
* sketch tables (``compress_locally``): rtol/atol 2e-5, the reference's
  kernel tolerance (``tests/test_kernels.py``), since the fused -log/pow
  differs from XLA's by a few ulps;
* one-pass values and ``tau``: rtol 1e-5, atol 1e-5 (estimates read from
  those tables, inverted through a pow);
* ``adamw.update``: rtol 1e-6, atol 1e-7 over 3 steps (float32 powers and
  square roots, a few ulps apart).

Two gloo ranks (spawned, each with its own accumulated gradient) are held
to the reference's own ``compress_locally`` and ``decode_sample`` composed
by hand: the two ranks' tables summed, their candidates concatenated in
rank order.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from repro.optim import adamw as jadamw
from repro.optim import gradcomp as JG
from repro_torch.optim import adamw
from repro_torch.optim import gradcomp as G

jax.config.update("jax_platform_name", "cpu")

TABLE_TOL = dict(rtol=2e-5, atol=2e-5)
EST_TOL = dict(rtol=1e-5, atol=1e-5)
ADAMW_TOL = dict(rtol=1e-6, atol=1e-7)
GLOO_TIMEOUT_S = 180.0
CODECS = ("none", "fp16", "q8", "size_adaptive", "q2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group (the world of one the reference's
    ``(1,)`` mesh is)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _shard_map():
    try:
        from jax import shard_map as sm
        return lambda f, mesh, specs: sm(f, mesh=mesh, in_specs=specs,
                                         out_specs=P(), check_vma=False)
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map as sm
        return lambda f, mesh, specs: sm(f, mesh=mesh, in_specs=specs,
                                         out_specs=P(), check_rep=False)


def _jrun(f, *args):
    mesh = jax.make_mesh((1,), ("data",))
    return jax.jit(_shard_map()(f, mesh, tuple(P() for _ in args)))(*args)


def _flat(seed=0, n=4096):
    a = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    a[:8] = np.arange(8, dtype=np.float32) * 50 + 100
    return a


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"wq": rng.normal(size=(64, 32)).astype(np.float32),
            "wk": rng.normal(size=1500).astype(np.float32),
            "b": rng.normal(size=130).astype(np.float32)}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_same_update(jout, tout, keys, exact_values: bool):
    """Supports identical; values bit for bit (exact) or within EST_TOL;
    the error trees bit for bit (a zeroed at the same ids)."""
    (js, je, _), (ts, te, _) = jout, tout
    for k in keys:
        x, y = _np(js[k]), _np(ts[k])
        assert np.array_equal(np.nonzero(x), np.nonzero(y)), k
        if exact_values:
            assert _bits(x) == _bits(y), k
        else:
            np.testing.assert_allclose(y, x, **EST_TOL)
        assert _bits(_np(je[k])) == _bits(_np(te[k])), k


def _assert_same_stats(jst, tst):
    assert sorted(jst) == sorted(tst)
    for k in jst:
        if k == "tau":
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), **EST_TOL)
        else:
            assert float(jst[k]) == float(tst[k]), k


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
@pytest.mark.parametrize("p", [0.5, 1.0, 2.0])
def test_compress_locally_matches_reference(p, scheme):
    cc = dict(k=16, rows=5, width=512, candidates=64, p=p, scheme=scheme)
    a = _flat(1)
    jt, jc = JG.compress_locally(jnp.asarray(a), JG.CompressorConfig(**cc))
    tt, tc = G.compress_locally(torch.tensor(a), G.CompressorConfig(**cc))
    np.testing.assert_allclose(_np(tt), _np(jt), **TABLE_TOL)
    assert _bits(_np(tc)) == _bits(_np(jc))


@pytest.mark.parametrize("scheme", ["ppswor", "priority"])
def test_decode_sample_matches_reference_on_the_same_table(scheme):
    """From the same merged table and candidates: the ids and tau bit for
    bit (bitwise reads, the same median), the inverted values within the
    pow's ulps."""
    cc = dict(k=16, rows=7, width=2048, candidates=256, p=1.0, scheme=scheme)
    rng = np.random.default_rng(1)
    a = rng.normal(size=2000).astype(np.float32) * (rng.random(2000) < 0.05)
    jt, jc = JG.compress_locally(jnp.asarray(a), JG.CompressorConfig(**cc))
    jids, jvals, jtau = JG.decode_sample(jt, jc, JG.CompressorConfig(**cc))
    tids, tvals, ttau = G.decode_sample(torch.tensor(np.asarray(jt)),
                                        torch.tensor(np.asarray(jc)),
                                        G.CompressorConfig(**cc))
    assert _bits(_np(tids)) == _bits(_np(jids))
    assert _bits(_np(ttau)) == _bits(_np(jtau))
    np.testing.assert_allclose(_np(tvals), _np(jvals), rtol=2e-6, atol=0)


def test_sample_is_wor_ppswor():
    """decode_sample picks exactly the perfect p-ppswor top-k when the
    candidates cover them (the reference's test, on the port)."""
    from repro_torch.core import perfect

    cc = G.CompressorConfig(k=16, rows=7, width=2048, candidates=256, p=1.0)
    rng = np.random.default_rng(1)
    a = rng.normal(size=2000).astype(np.float32) * (rng.random(2000) < 0.05)
    table, cand = G.compress_locally(torch.tensor(a), cc)
    ids, _, _ = G.decode_sample(table, cand, cc)
    oracle = perfect.ppswor_sample(torch.tensor(a), cc.k, cc.p,
                                   torch.tensor(cc.seed))
    assert set(ids.tolist()) == set(oracle.keys.tolist())


@pytest.mark.parametrize("seed", [0, 0x5EED, 2**32 - 1, 123456789])
def test_leaf_salt_bitwise(seed):
    for li in (0, 1, 7, 1000, 2**20):
        j = JG._leaf_salt(JG.CompressorConfig(seed=seed), li)
        t = G._leaf_salt(G.CompressorConfig(seed=seed), li)
        assert t.dtype == np.uint32 and int(t) == int(j)


def test_fused_key_wraps_as_int32():
    """``tag * 2**22 + id % 2**22`` in int32, past the wrap (tags >= 512)."""
    rng = np.random.default_rng(3)
    tags = np.concatenate([rng.integers(0, 2000, 500),
                           [0, 511, 512, 1023, 1999]]).astype(np.int32)
    ids = np.concatenate([rng.integers(0, 2**31 - 1, 500),
                          [0, 2**22 - 1, 2**22, 2**31 - 1, 5]]).astype(
                              np.int32)
    want = np.asarray(jnp.asarray(tags) * jnp.int32(2**22)
                      + (jnp.asarray(ids) % jnp.int32(2**22)))
    got = G._fused_key(torch.tensor(tags), torch.tensor(ids))
    assert got.dtype == torch.int32
    assert _bits(got.numpy()) == _bits(want)


def test_no_process_group_raises():
    assert not dist.is_initialized()
    cc = G.CompressorConfig(k=4, rows=3, width=64, candidates=8)
    g = {"w": torch.ones(32)}
    with pytest.raises(RuntimeError, match="process group"):
        G.compress_step(torch.ones(32), cc)
    for fn in (G.tree_compress_step, G.tree_compress_step_sharded,
               G.tree_compress_step_engine):
        with pytest.raises(RuntimeError, match="process group"):
            fn(g, G.init_error(g), cc)


# ---------------------------------------------------------------------------
# the rounds at a world of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator", ["raw", "ht"])
@pytest.mark.parametrize("mode", ["twopass", "onepass"])
def test_compress_step_matches_reference(group, mode, estimator):
    cc = dict(k=32, rows=5, width=512, candidates=64, p=1.0, mode=mode,
              estimator=estimator)
    a = _flat(0)
    jout = _jrun(lambda x: JG.compress_step(x, JG.CompressorConfig(**cc),
                                            ("data",)), jnp.asarray(a))
    tout = G.compress_step(torch.tensor(a), G.CompressorConfig(**cc), group)
    _assert_same_update(({"v": jout[0]}, {"v": jout[1]}, None),
                        ({"v": tout[0]}, {"v": tout[1]}, None), ["v"],
                        exact_values=(mode, estimator) == ("twopass", "raw"))
    _assert_same_stats(jout[2], tout[2])


def test_compression_invariants_single_worker(group):
    """One worker + twopass: sampled ids carry exact values and error
    feedback holds exactly the untransmitted residual (the reference's
    test, bit for bit here)."""
    cc = G.CompressorConfig(k=32, rows=5, width=512, candidates=64, p=1.0,
                            mode="twopass")
    a = torch.tensor(_flat(0))
    sparse, err, _ = G.compress_step(a, cc, group)
    nz = torch.nonzero(sparse).ravel()
    assert len(nz) == cc.k
    assert torch.equal(sparse[nz], a[nz])
    assert torch.equal(sparse + err, a)


PATHS = {
    "flat": (lambda g, e, cc: JG.tree_compress_step(g, e, cc, ("data",)),
             lambda g, e, cc, grp: G.tree_compress_step(g, e, cc, grp)),
    "sharded": (lambda g, e, cc: JG.tree_compress_step_sharded(
                    g, e, cc, ("data",)),
                lambda g, e, cc, grp: G.tree_compress_step_sharded(
                    g, e, cc, grp)),
    "engine": (lambda g, e, cc: JG.tree_compress_step_engine(
                   g, e, cc, ("data",), k_per_leaf=16),
               lambda g, e, cc, grp: G.tree_compress_step_engine(
                   g, e, cc, grp, k_per_leaf=16)),
}


@pytest.mark.parametrize("mode", ["twopass", "onepass"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_tree_paths_match_reference(group, path, mode):
    cc = dict(k=32, rows=5, width=512, p=1.0, mode=mode)
    grads = _grads(0)
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tg = {k: torch.tensor(v) for k, v in grads.items()}
    jf, tf = PATHS[path]
    jout = _jrun(lambda g, e: jf(g, e, JG.CompressorConfig(**cc)), jg,
                 JG.init_error(jg))
    tout = tf(tg, G.init_error(tg), G.CompressorConfig(**cc), group)
    _assert_same_update(jout, tout, grads, exact_values=mode == "twopass")
    _assert_same_stats(jout[2], tout[2])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("path", sorted(PATHS))
def test_comm_bytes_under_every_codec(group, path, codec):
    """The static wire accounting equals the reference's under every codec
    (and the lossy grids leave the twopass supports as the reference's)."""
    cc = dict(k=16, rows=5, width=512, p=1.0, codec=codec)
    grads = _grads(2)
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tg = {k: torch.tensor(v) for k, v in grads.items()}
    jf, tf = PATHS[path]
    jout = _jrun(lambda g, e: jf(g, e, JG.CompressorConfig(**cc)), jg,
                 JG.init_error(jg))
    tout = tf(tg, G.init_error(tg), G.CompressorConfig(**cc), group)
    for k in ("comm_bytes", "comm_floats", "dense_bytes", "dense_floats"):
        assert float(jout[2][k]) == float(tout[2][k]), k
    for k in grads:
        assert np.array_equal(np.nonzero(_np(jout[0][k])),
                              np.nonzero(_np(tout[0][k]))), k


def test_engine_path_invariants_and_small_leaf(group):
    """Every layer represented, exact values, ``sparse + err == a`` bit for
    bit; a leaf smaller than k_per_leaf neither crashes nor corrupts (the
    reference's tests/test_engine.py cases)."""
    cc = G.CompressorConfig(k=32, rows=3, width=256, p=1.0, mode="twopass")
    rng = np.random.default_rng(1)
    grads = {"w": torch.tensor(rng.normal(size=(64, 32)).astype(np.float32)),
             "scale": torch.tensor(rng.normal(size=8).astype(np.float32))}
    sparse, err, stats = G.tree_compress_step_engine(
        grads, G.init_error(grads), cc, group, k_per_leaf=32,
        cand_per_leaf=64)
    for name, g in grads.items():
        s = sparse[name].ravel()
        nz = torch.nonzero(s).ravel()
        assert 1 <= len(nz) <= 32
        assert torch.equal(s[nz], g.ravel()[nz])
        assert torch.equal(sparse[name] + err[name], g)
    assert float(stats["comm_floats"]) < float(stats["dense_floats"]) * 10


def test_error_feedback_steps_with_adamw_match_reference(group):
    """The slice as a whole: three error-feedback steps of the engine path,
    each applied by ``adamw.update`` to float32 parameters, against the
    same loop in the JAX package: the same supports every step, the
    parameters and the error trees within the stated tolerances."""
    cc = dict(k=32, rows=5, width=512, p=1.0, mode="twopass")
    rng = np.random.default_rng(5)
    params = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in _grads(0).items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    je, te = JG.init_error(jp), G.init_error(tp)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        g = {k: v * (1.0 + step) for k, v in _grads(10 + step).items()}
        jsp, je, _ = _jrun(lambda a, b: JG.tree_compress_step_engine(
            a, b, JG.CompressorConfig(**cc), ("data",), k_per_leaf=16),
            {k: jnp.asarray(v) for k, v in g.items()}, je)
        tsp, te, _ = G.tree_compress_step_engine(
            {k: torch.tensor(v) for k, v in g.items()}, te,
            G.CompressorConfig(**cc), group, k_per_leaf=16)
        for k in g:
            assert np.array_equal(np.nonzero(_np(jsp[k])),
                                  np.nonzero(_np(tsp[k]))), (step, k)
            assert _bits(_np(jsp[k])) == _bits(_np(tsp[k])), (step, k)
            assert _bits(_np(je[k])) == _bits(_np(te[k])), (step, k)
        jp, js = jadamw.update(jp, jsp, js)
        tp, ts = adamw.update(tp, tsp, ts)
        for k in params:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **ADAMW_TOL)


# ---------------------------------------------------------------------------
# adamw
# ---------------------------------------------------------------------------

def test_adamw_init_matches_reference():
    params = {"w": np.ones((3, 4), np.float32),
              "b": np.ones(5, np.float32).astype(jnp.bfloat16)}
    js = jadamw.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = adamw.init({"w": torch.ones(3, 4),
                     "b": torch.ones(5, dtype=torch.bfloat16)})
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 0
    for k in params:
        assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32
        assert _bits(_np(ts.mu[k])) == _bits(_np(js.mu[k]))


@pytest.mark.parametrize("hyper", [{}, dict(lr=1e-2, b1=0.8, b2=0.99,
                                            eps=1e-6, weight_decay=0.0)])
def test_adamw_three_steps_match_reference(hyper):
    rng = np.random.default_rng(7)
    p32 = rng.normal(size=(16, 8)).astype(np.float32)
    jp = {"w": jnp.asarray(p32), "v": jnp.asarray(p32[0])}
    tp = {"w": torch.tensor(p32), "v": torch.tensor(p32[0])}
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        g = rng.normal(size=(16, 8)).astype(np.float32) * (step + 1)
        jp, js = jadamw.update(jp, {"w": jnp.asarray(g),
                                    "v": jnp.asarray(g[1])}, js, **hyper)
        tp, ts = adamw.update(tp, {"w": torch.tensor(g),
                                   "v": torch.tensor(g[1])}, ts, **hyper)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("w", "v"):
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **ADAMW_TOL)
            np.testing.assert_allclose(_np(ts.mu[k]), _np(js.mu[k]),
                                       **ADAMW_TOL)
            np.testing.assert_allclose(_np(ts.nu[k]), _np(js.nu[k]),
                                       **ADAMW_TOL)


def test_adamw_bfloat16_params_keep_their_dtype():
    rng = np.random.default_rng(8)
    p = rng.normal(size=64).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    jp, js = jadamw.update({"p": jnp.asarray(p, jnp.bfloat16)},
                           {"p": jnp.asarray(g)},
                           jadamw.init({"p": jnp.asarray(p, jnp.bfloat16)}))
    tp0 = {"p": torch.tensor(p).to(torch.bfloat16)}
    tp, ts = adamw.update(tp0, {"p": torch.tensor(g)}, adamw.init(tp0))
    assert tp["p"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["p"].float().numpy(),
                               np.asarray(jp["p"], np.float32),
                               rtol=8e-3, atol=0)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def _rank_grad(rank):
    a = np.random.default_rng([11, rank]).normal(size=4096).astype(
        np.float32)
    a[rank * 8:rank * 8 + 8] += 200.0  # each rank's own heavy coordinates
    return a


TWO_RANK_CC = dict(k=32, rows=5, width=512, candidates=64, p=1.0,
                   mode="twopass")


def _gloo_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cc = G.CompressorConfig(**TWO_RANK_CC)
        sparse, err, stats = G.compress_step(torch.tensor(_rank_grad(rank)),
                                             cc)
        g = {"a": torch.tensor(_rank_grad(rank)[:3000]),
             "b": torch.tensor(_rank_grad(rank)[3000:])}
        es, _, _ = G.tree_compress_step_engine(g, G.init_error(g), cc)
        ss, _, _ = G.tree_compress_step_sharded(g, G.init_error(g), cc)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 sparse=sparse.numpy(), err=err.numpy(),
                 tau=stats["tau"].numpy(),
                 engine=np.concatenate([es["a"].numpy(), es["b"].numpy()]),
                 sharded=np.concatenate([ss["a"].numpy(),
                                         ss["b"].numpy()]))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_match_reference_composed_by_hand(tmp_path):
    world = 2
    ctx = mp.start_processes(_gloo_rank, args=(world, str(tmp_path / "store"),
                                               str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"gloo ranks did not finish within "
                                     f"{GLOO_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10.0)
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]

    cc = JG.CompressorConfig(**TWO_RANK_CC)
    parts = [JG.compress_locally(jnp.asarray(_rank_grad(r)), cc)
             for r in range(world)]
    table = np.asarray(parts[0][0]) + np.asarray(parts[1][0])
    cand = np.concatenate([np.asarray(c) for _, c in parts])
    ids, _, tau = JG.decode_sample(jnp.asarray(table), jnp.asarray(cand), cc)
    ids = np.asarray(ids)
    vals = (_rank_grad(0)[ids] + _rank_grad(1)[ids]) / np.float32(2.0)
    for r in range(world):
        want = np.zeros(4096, np.float32)
        want[ids] = vals
        err = _rank_grad(r).copy()
        err[ids] = 0.0
        assert _bits(got[r]["sparse"]) == _bits(want), r
        assert _bits(got[r]["err"]) == _bits(err), r
        np.testing.assert_allclose(got[r]["tau"], np.asarray(tau),
                                   **EST_TOL)
        # every rank decodes the same per-layer and sharded updates
        for key in ("engine", "sharded"):
            assert _bits(got[r][key]) == _bits(got[0][key]), (r, key)
            assert np.count_nonzero(got[r][key]) > 0
