"""The port's examples (``examples/torch_*.py``) on the CPU, each through
its ``main(["--device", "cpu", ...])`` at a small size, its printed claims
checked and its samples held to the JAX package's functions on the same
seeds and data (computed here, not parsed from the reference scripts).

Tolerances: sample keys identical; one-pass frequencies and HT sums
within rtol 1e-5 where both sum in one order, 1e-4 where the port's
kernel path (its plain version here) sums a table in another order than
the reference's plain update; the serve example's logits allclose (rtol
1e-4, atol 1e-3 x max(1, max|logit|), float32 weights carried across with
``repro_torch.convert``) and its greedy ids equal.  The train example
spawns 4 gloo ranks, joined within its ``--timeout``; its losses are held
to the reference's compressed step over 4 ranks (rtol 1e-5 to 2e-4 by
step, stated at the test).
"""
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import estimators as jest
from repro.core import perfect as jperfect
from repro.core import worp as jworp
from repro.data.ingest_pipeline import PrefetchingFeeder as JFeeder
from repro.data.ingest_pipeline import ShardedSource as JSource
from repro.data.pipeline import FrequencySketcher as JSketcher
from repro.data.pipeline import TurnstileZipfStream as JTurnstile
from repro.data.pipeline import ZipfStream as JZipf
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FlushPolicy as JFlushPolicy
from repro.engine import SketchEngine as JSketchEngine
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.base import get_config

jax.config.update("jax_platform_name", "cpu")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def test_quickstart_matches_reference():
    n, k, p, seed_t = 5000, 32, 1.0, 1234
    got = _load("torch_quickstart").main(CPU + ["--n", str(n), "--k",
                                                str(k)])
    assert got["two_pass_equals_perfect"] is True
    rng = np.random.default_rng(0)
    freqs = (np.arange(1, n + 1) ** -1.2 * 5_000).astype(np.float32)
    freqs = freqs[rng.permutation(n)]
    keys, vals, batch = jnp.arange(n), jnp.asarray(freqs), n // 8
    st = jworp.onepass_init(rows=5, width=31 * k, candidates=4 * k,
                            seed_sketch=7, seed_transform=seed_t)
    for lo in range(0, n, batch):
        st = jworp.onepass_update(st, keys[lo:lo + batch],
                                  vals[lo:lo + batch], p)
    t = jworp.twopass_init(capacity=2 * (k + 1), seed_transform=seed_t)
    for lo in range(0, n, batch):
        t = jworp.twopass_update(t, st.sketch, keys[lo:lo + batch],
                                 vals[lo:lo + batch])
    two = jworp.twopass_sample(t, k, p)
    oracle = set(np.asarray(jperfect.ppswor_sample(vals, k, p,
                                                   seed_t).keys).tolist())
    one = set(np.asarray(jworp.onepass_sample(st, k, p).keys).tolist())
    assert got["one_pass_keys"] == sorted(one)
    assert got["two_pass_keys"] == sorted(np.asarray(two.keys).tolist())
    assert got["one_pass_overlap"] == len(one & oracle)
    np.testing.assert_allclose(
        got["est_l1"], float(jest.sum_statistic(two, p, jnp.abs)),
        rtol=1e-5)


def test_stream_sampling_matches_reference():
    steps = 4
    got = _load("torch_stream_sampling").main(CPU + ["--steps", str(steps)])
    assert got["merged_equals_union"] is True
    stream = JZipf(vocab_size=5_000, alpha=1.5, seed=42)
    shards = [JSketcher(k=64, p=0.5, seed=99) for _ in range(4)]
    for step in range(steps):
        for shard_id, sk in enumerate(shards):
            sk.observe(jnp.asarray(stream.batch_at(step, shard_id, 8, 128)))
    for other in shards[1:]:
        shards[0].merge_from(other)
    s = shards[0].sample()
    want = dict(zip(np.asarray(s.keys).tolist(),
                    np.asarray(s.freqs).tolist()))
    have = dict(zip(got["sample_keys"], got["sample_freqs"]))
    assert sorted(have) == sorted(want)
    np.testing.assert_allclose([have[x] for x in sorted(want)],
                               [want[x] for x in sorted(want)], rtol=1e-4)
    w = shards[0].selection_weights(jnp.asarray(stream.batch_at(100, 0, 2,
                                                                16)))
    np.testing.assert_allclose(got["weights"], np.asarray(w), rtol=1e-4)


def _turnstile_batches(nsteps, B=4, n=64):
    stream = JTurnstile(vocab_size=512, alpha=1.6, seed=3,
                        delete_fraction=0.25)
    for t in range(nsteps):
        rows = [stream.sparse_batch_at(t, shard=b, n=n) for b in range(B)]
        yield (np.stack([k for k, _ in rows]).astype(np.int32),
               np.stack([v for _, v in rows]).astype(np.float32))


JCFG = dict(num_streams=4, rows=5, width=512, candidates=64, p=1.0, seed=7)


def test_async_ingest_matches_reference():
    steps = 6
    got = _load("torch_async_ingest").main(CPU + ["--steps", str(steps)])
    assert got["async_equals_sync"] is True
    assert got["aggregate_equals_single"] is True
    eng = JSketchEngine(JEngineConfig(**JCFG), plane="async",
                        flush=JFlushPolicy(max_elems=256))
    try:
        for k, v in _turnstile_batches(steps):
            eng.ingest(k, v)
        eng.flush()
        s = eng.sample(8)
    finally:
        eng.plane.close()
    np.testing.assert_array_equal(got["sample_keys"], np.asarray(s.keys))
    np.testing.assert_allclose(got["sample_freqs"], np.asarray(s.freqs),
                               rtol=1e-5, atol=1e-4)


def test_sharded_ingest_matches_reference():
    steps = 8
    got = _load("torch_sharded_ingest").main(CPU + ["--steps", str(steps)])
    assert got["fan_in_equals_sync"] is True and got["pershard_close"] is True
    eng = JSketchEngine(JEngineConfig(**JCFG), plane="sparse",
                        flush_elems=1)
    stream = JTurnstile(vocab_size=512, alpha=1.6, seed=3,
                        delete_fraction=0.25)
    src = JSource.from_turnstile(stream, n=96, num_shards=4, nsteps=steps)
    stats = JFeeder(src, eng, block_elems=256, prefetch=2).run()
    eng.plane.close()
    assert got["events"] == stats.events
    want = np.asarray(eng.state.sketch.table)
    np.testing.assert_allclose(got["table"], want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_serve_example_matches_reference():
    ex = _load("torch_serve_example")
    jcfg = jget_config("mamba2_13b").reduced()
    cfg = get_config("mamba2_13b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (ex.B, ex.S)).astype(np.int32)
    n = 6
    logits, leaves, gen = ex.generate(cfg, tp, torch.tensor(prompts), n)
    jl, cache = JT.forward_prefill(jp, {"tokens": jnp.asarray(prompts)}, jcfg)
    assert leaves == len(jax.tree_util.tree_leaves(cache))
    want_l = np.asarray(jl)
    np.testing.assert_allclose(
        logits.numpy(), want_l, rtol=1e-4,
        atol=1e-3 * max(1.0, float(np.abs(want_l).max())))
    tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ids = [np.asarray(tok)]
    for i in range(n):
        lg, cache = JT.forward_decode(
            jp, {"token": tok, "pos": jnp.int32(ex.S + i), "cache": cache},
            jcfg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        ids.append(np.asarray(tok))
    np.testing.assert_array_equal(gen.numpy(), np.concatenate(ids, axis=1))
    out = ex.main(CPU + ["--tokens", "2"])
    assert out["finite"] is True and out["state_leaves"] == leaves
    assert np.asarray(out["ids"]).shape == (ex.B, 3)


def _reference_compressed_losses(ex, n):
    """The first ``n`` losses of the reference's compressed DP step
    (``repro.train.steps.make_compressed_train_step``'s local step:
    ``train_loss``, its gradient, ``gradcomp.tree_compress_step`` over the
    ``data`` axis, ``adamw.update``) on the example's Zipf batches, from
    the port's initial weights of the example's seed, over
    ``ex.CPU_RANKS`` ranks each on its own rows.  The ranks run under
    ``vmap`` with a named axis, each keeping its own error feedback, as
    the port's ranks do (the reference's ``shard_map`` declares its error
    replicated and returns one rank's)."""
    from repro.data.pipeline import ZipfStream as JZipfStream
    from repro.optim import adamw as jadamw
    from repro.optim import gradcomp as jgradcomp
    from repro_torch.distributed import pytree
    from repro_torch.models import model as M

    W = ex.CPU_RANKS
    cfg, jcfg = get_config(ex.ARCH).reduced(), jget_config(ex.ARCH).reduced()
    params = M.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                           device="cpu")
    assert {p.dtype for p in pytree.leaves(params)} == {torch.bfloat16}
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                convert.params_to_numpy(params))
    cc = jgradcomp.CompressorConfig(**ex.CC)

    def local(params, opt, error, batch):
        loss, grads = jax.value_and_grad(
            lambda q: JM.train_loss(q, batch, jcfg))(params)
        loss = jax.lax.pmean(loss, "data")
        sparse, error, _ = jgradcomp.tree_compress_step(grads, error, cc,
                                                        ("data",))
        params, opt = jadamw.update(params, sparse, opt, lr=ex.LR)
        return params, opt, error, loss

    step = jax.jit(jax.vmap(local, axis_name="data"))
    ranks = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.broadcast_to(x, (W,) + x.shape), tree)
    state = (ranks(jp), ranks(jadamw.init(jp)),
             ranks(jgradcomp.init_error(jp)))
    stream = JZipfStream(vocab_size=jcfg.vocab_size, alpha=1.2, seed=0)
    losses = []
    for i in range(n):
        b = {k: v.reshape(W, ex.BATCH // W, ex.SEQ)
             for k, v in stream.lm_batch(i, 0, ex.BATCH, ex.SEQ).items()}
        *state, loss = step(*state, b)
        losses.append(float(loss[0]))
    return losses


def test_train_example_trains_and_resumes(tmp_path, monkeypatch):
    """Two steps, then a resume from the checkpoint for a third, held to
    the reference's compressed step on the same weights, data and seeds.
    Step 0's loss is the initial weights' (rtol 1e-5); step 1's follows
    the first compressed update, whose candidates are the union of the
    ranks' own (rtol 5e-5: the same update over one rank's whole batch
    is 4e-4 away); step 2's follows two updates of bfloat16 weights,
    where float32 summation orders move a rounding (rtol 2e-4)."""
    # the ranks are spawned: they unpickle ``train`` by importing the
    # example under its own name, from the parent's sys.path
    monkeypatch.syspath_prepend(str(EXAMPLES))
    ex = importlib.import_module("torch_train_worp_compressed")
    ckpt = str(tmp_path / "ckpt")
    first = ex.main(CPU + ["--steps", "2", "--ckpt", ckpt, "--timeout",
                           "300"])
    assert len(first["losses"]) == 2
    again = ex.main(CPU + ["--steps", "3", "--ckpt", ckpt, "--timeout",
                           "300"])
    assert len(again["losses"]) == 1
    assert again["final_loss"] == again["losses"][0]
    got = first["losses"] + again["losses"]
    want = _reference_compressed_losses(ex, 3)
    for loss, ref, rtol in zip(got, want, (1e-5, 5e-5, 2e-4)):
        np.testing.assert_allclose(loss, ref, rtol=rtol)
