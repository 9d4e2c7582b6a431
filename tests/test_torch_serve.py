"""The port's multi-worker serving helpers (``repro_torch.launch.serve``)
against the JAX package's (``repro.launch.serve``), on the CPU.

* ``aggregate_worker_states`` over the reference's worker states (carried
  across by ``convert.py``) equals the reference's aggregate bit for bit,
  at 4 workers (the butterfly) and 3 (the tree), under ``none`` and q8.
* Fed the same round-robin decode stream, ``sample_aggregated`` gives the
  reference's sample keys and those of one engine that saw every step.
* A worker of another config (another seed) raises; so do no workers.
* ``generate`` with the reference's float32 weights (reduced gemma2_2b and
  qwen25_32b) against the reference's serving loop, driven step by step
  through ``forward_prefill``/``forward_decode`` and teacher-forced on the
  reference's ids: prefill and every step's logits allclose (rtol 1e-4,
  atol 5e-4 x max(1, max|want|), as tests/test_torch_models.py), the same
  greedy ids (the smallest gap between a step's two largest reference
  logits is asserted above that tolerance, so no near tie decides), and at
  ``--worp-topk 5`` the reference's aggregated sample keys, unbounded and
  with ``--worp-window 3``, on 1 and 2 workers.
* ``main([... --device cpu --reduced ...])`` runs end to end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_NAMES, get_config
from repro.engine import EngineConfig as JConfig
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.launch import serve

jax.config.update("jax_platform_name", "cpu")


def _cfg(name="onepass", seed=7):
    return dict(num_streams=3, rows=3, width=128, candidates=16, capacity=16,
                p=1.0, seed=seed, sampler=name, domain=40, num_samplers=8)


def _steps(n=12, seed=9):
    """One decode step per call: a token a request, well-separated
    frequencies (a few heavy tokens)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, (n, 3, 4)).astype(np.int32)
    vals = (1 + (keys % 5 == 0) * 9).astype(np.float32)
    return list(zip(keys, vals))


def _feed(workers, steps):
    for t, (k, v) in enumerate(steps):
        workers[t % len(workers)].ingest(k, v)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


# twopass crosses fp16, not q8: q8 turns its -inf priority padding into NaN
@pytest.mark.parametrize("n_workers", [3, 4])
@pytest.mark.parametrize("name,codec", [
    ("onepass", "none"), ("onepass", "q8"), ("twopass", "none"),
    ("twopass", "fp16"), ("tv", "none"), ("tv", "q8")])
def test_aggregate_equals_reference_bitwise(name, codec, n_workers):
    jworkers = jserve.make_worker_engines(JConfig(**_cfg(name)), n_workers,
                                          flush_elems=1)
    _feed(jworkers, _steps())
    workers = serve.make_worker_engines(EngineConfig(**_cfg(name)),
                                        n_workers, flush_elems=1,
                                        device="cpu")
    for w, jw in zip(workers, jworkers):
        w.state = convert.state_from_numpy(
            type(w.state), [np.asarray(x) for x in
                            jax.tree_util.tree_leaves(jw.flush().state)],
            "cpu")
    got = convert.state_to_numpy(serve.aggregate_worker_states(workers,
                                                               codec=codec))
    want = jax.tree_util.tree_leaves(
        jserve.aggregate_worker_states(jworkers, codec=codec))
    assert [_bits(g) for g in got] == [_bits(np.asarray(w)) for w in want]


@pytest.mark.parametrize("n_workers", [1, 3, 4])
def test_sample_aggregated_equals_one_engine_and_reference(n_workers):
    steps = _steps()
    workers = serve.make_worker_engines(EngineConfig(**_cfg()), n_workers,
                                        flush_elems=1, device="cpu")
    _feed(workers, steps)
    jworkers = jserve.make_worker_engines(JConfig(**_cfg()), n_workers,
                                          flush_elems=1)
    _feed(jworkers, steps)
    single = SketchEngine(EngineConfig(**_cfg()), flush_elems=1,
                          device="cpu")
    _feed([single], steps)
    got = serve.sample_aggregated(workers, 4)
    assert np.array_equal(got.keys.numpy(),
                          np.asarray(jserve.sample_aggregated(jworkers,
                                                              4).keys))
    assert np.array_equal(np.sort(got.keys.numpy(), 1),
                          np.sort(single.sample(4).keys.numpy(), 1))


def test_mismatched_workers_and_none_raise():
    workers = serve.make_worker_engines(EngineConfig(**_cfg()), 2,
                                        device="cpu")
    rogue = SketchEngine(EngineConfig(**_cfg(seed=8)), device="cpu")
    with pytest.raises(ValueError, match="config differs"):
        serve.aggregate_worker_states(workers + [rogue])
    with pytest.raises(ValueError, match="no workers"):
        serve.aggregate_worker_states([])
    with pytest.raises(ValueError, match="workers must be"):
        serve.make_worker_engines(EngineConfig(**_cfg()), 0, device="cpu")
    # states of another seed under one config: the merge trees' seed guard
    workers[1].state = rogue.state
    with pytest.raises(ValueError, match="seeds"):
        serve.aggregate_worker_states(workers, codec="q8")


PROMPT, DECODE = 16, 6


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine_cfg(cfg, k):
    """The serving CLI's analytics engine at ``--worp-topk k``."""
    return dict(num_streams=2, rows=5, width=max(256, 31 * k),
                candidates=4 * k, p=1.0, seed=0x5EED, sampler="onepass",
                domain=cfg.vocab_size, num_samplers=max(4, k))


def _reference_grow(cfg, S, n):
    """The reference's ``grow`` (``repro.launch.serve.main``, a closure
    there): every leaf whose axis 2 is the prompt's length (or the vlm's
    prompt + patches) padded by the decode budget ``n``."""
    P = cfg.num_patches if cfg.family == "vlm" else 0
    full = S + n + P

    def grow(x):
        if x.ndim >= 4 and x.shape[2] in (S, S + cfg.num_patches):
            pad = [(0, 0)] * x.ndim
            pad[2] = (0, full - x.shape[2])
            return jnp.pad(x, pad)
        return x
    return grow


def _reference_loop(jp, cfg, toks, k=0, window=0, workers=1,
                    patch_embeds=None):
    """The reference's serving loop (repro.launch.serve.main) with given
    weights (and the vlm's patch embeddings): the (B, DECODE + 1) ids, the
    prefill's last logits and each step's, and the aggregated sample (None
    without k)."""
    S = toks.shape[1]
    batch = {"tokens": jnp.asarray(toks)}
    if patch_embeds is not None:
        batch["patch_embeds"] = jnp.asarray(patch_embeds)
    pos0 = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    logits, cache = JT.forward_prefill(jp, batch, cfg)
    cache = jax.tree_util.tree_map(_reference_grow(cfg, S, DECODE), cache)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    steps = [np.asarray(logits[:, -1:])]
    engines = jserve.make_worker_engines(JConfig(**_engine_cfg(cfg, k)),
                                         workers) if k else []
    held, nstep = [], 0

    def ingest_step(t):
        widx = nstep % len(engines)
        engines[widx].ingest(t, np.ones(t.shape, np.float32))
        if window:
            held.append((widx, np.asarray(t)))
            if len(held) > window:
                oidx, old = held.pop(0)
                engines[oidx].ingest(old, -np.ones(old.shape, np.float32))

    if engines:
        if not window:
            engines[0].ingest(toks, np.ones(toks.shape, np.float32))
        ingest_step(tok)
        nstep += 1
    outs = [np.asarray(tok)]
    for i in range(DECODE):
        lg, cache = JT.forward_decode(jp, {"token": tok,
                                           "pos": jnp.int32(pos0 + i),
                                           "cache": cache}, cfg)
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        outs.append(np.asarray(tok))
        if engines:
            ingest_step(tok)
            nstep += 1
    sample = jserve.sample_aggregated(engines, k) if engines else None
    return np.concatenate(outs, axis=1), steps, sample


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=5e-4 * max(1.0, float(np.abs(want).max())))


def _model(name, seed=0, prompt=PROMPT):
    """The reduced config of both packages, the reference's float32
    weights in both, a (2, prompt) prompt and, for the vlm, (2, P, D)
    patch embeddings (numpy, N(0, 1) x 0.02; else None)."""
    cfg = get_config(name).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    pe = None
    if cfg.family == "vlm":
        pe = (rng.standard_normal((2, cfg.num_patches, cfg.d_model))
              * 0.02).astype(np.float32)
    return cfg, tbase.get_config(name).reduced(), jp, tp, toks, pe


# (arch, prompt, weights' seed): a prompt where the reference runs (the
# reduced mamba2's 16 heads would meet the reference's grow at a 16-token
# prompt, ROADMAP Queue 3); recurrentgemma's seed-0 weights put two of a
# step's reference logits 4.6e-4 apart, inside the logits' tolerance, so
# greedy ids could part on rounding alone: seed 1
GENERATE = [("gemma2_2b", PROMPT, 0), ("qwen25_32b", PROMPT, 0),
            ("olmoe_1b_7b", PROMPT, 0), ("mamba2_13b", 32, 0),
            ("recurrentgemma_9b", PROMPT, 1), ("phi3_vision_42b", PROMPT, 0)]


@pytest.mark.parametrize("name,prompt,seed", GENERATE,
                         ids=[g[0] for g in GENERATE])
def test_generate_equals_the_reference_loop(name, prompt, seed, one_thread):
    from repro_torch.models import transformer as T

    cfg, tcfg, jp, tp, toks, pe = _model(name, seed, prompt)
    want_ids, want_steps, _ = _reference_loop(jp, cfg, toks,
                                              patch_embeds=pe)
    gaps = [np.diff(np.sort(st, axis=-1)[..., -2:], axis=-1).min()
            for st in want_steps]
    assert min(gaps) > 5e-4 * max(1.0, max(np.abs(st).max()
                                           for st in want_steps))
    P = 0 if pe is None else pe.shape[1]
    batch = {"tokens": torch.from_numpy(toks)}
    if pe is not None:
        batch["patch_embeds"] = torch.from_numpy(pe)
    with torch.no_grad():  # teacher-forced on the reference's ids
        lg, cache = T.forward_prefill(tp, batch, tcfg)
        _close(lg[:, -1:].numpy(), want_steps[0])
        cache = serve.grow_cache(cache, prompt, prompt + P + DECODE, P)
        for i in range(DECODE):
            lg, cache = T.forward_decode(tp, {
                "token": torch.from_numpy(want_ids[:, i:i + 1]),
                "pos": prompt + P + i, "cache": cache}, tcfg)
            _close(lg.numpy(), want_steps[i + 1])
    gen = serve.generate(tp, torch.from_numpy(toks), tcfg, DECODE,
                         patch_embeds=batch.get("patch_embeds"))
    assert gen.ids.dtype == np.int32
    assert np.array_equal(gen.ids, want_ids)


@pytest.mark.parametrize("name,prompt", [g[:2] for g in GENERATE[2:]],
                         ids=[g[0] for g in GENERATE[2:]])
def test_generate_analytics_of_every_family_equal_the_reference(
        name, prompt, one_thread):
    """--worp-topk 5 over the moe, ssm, hybrid and vlm families: the ids
    and the aggregated per-request sample of the reference's loop."""
    cfg, tcfg, jp, tp, toks, pe = _model(name, seed=4, prompt=prompt)
    want_ids, _, want = _reference_loop(jp, cfg, toks, k=5,
                                        patch_embeds=pe)
    engines = serve.make_worker_engines(
        EngineConfig(**_engine_cfg(tcfg, 5)), 1, device="cpu")
    gen = serve.generate(tp, torch.from_numpy(toks), tcfg, DECODE, engines,
                         patch_embeds=None if pe is None
                         else torch.from_numpy(pe))
    assert np.array_equal(gen.ids, want_ids)
    got = serve.sample_aggregated(engines, 5)
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_allclose(got.freqs.numpy(), np.asarray(want.freqs),
                               rtol=1e-5)


def _tree_eq(got, want):
    assert sorted(got) == sorted(want)
    return all(_tree_eq(got[k], want[k]) if isinstance(got[k], dict)
               else np.array_equal(got[k].numpy(), np.asarray(want[k]))
               for k in want)


@pytest.mark.parametrize("prompt", [16, 32])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_grow_cache_equals_the_reference_grow(name, prompt, one_thread):
    """Every family's prefill cache grown by the decode budget equals the
    reference's ``grow`` where the reference runs, the rings of
    ``local_window`` = 16 = prompt slots grown too; the reduced mamba2's
    16-head SSM state at a 16-token prompt is where they part: the
    reference pads the state's head axis, the port leaves it."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    cfg = get_config(name).reduced()
    tcfg = tbase.get_config(name).reduced()
    tp = M.init_params(tcfg, torch.Generator().manual_seed(0),
                       dtype=torch.float32)
    batch = M.concrete_inputs(tcfg, tbase.ShapeCell("p", prompt, 2,
                                                    "prefill"),
                              dtype=torch.float32)
    if tcfg.family == "vlm":  # the text after the patches
        batch = M.concrete_inputs(tcfg, tbase.ShapeCell(
            "p", prompt + tcfg.num_patches, 2, "prefill"),
            dtype=torch.float32)
    with torch.no_grad():
        _, cache = T.forward_prefill(tp, batch, tcfg)
    P = tcfg.num_patches if tcfg.family == "vlm" else 0
    got = serve.grow_cache(cache, prompt, prompt + P + DECODE, P)
    want = jax.tree_util.tree_map(_reference_grow(cfg, prompt, DECODE),
                                  convert.params_to_numpy(cache))
    fault = (name, prompt) == ("mamba2_13b", 16)
    assert _tree_eq(got, want) != fault
    if fault:
        assert want["layers"]["ssm"].shape[2] == 16 + DECODE
        assert tuple(got["layers"]["ssm"].shape) == tuple(
            cache["layers"]["ssm"].shape)


@pytest.mark.parametrize("name,prompt", [("mamba2_13b", 16),
                                         ("recurrentgemma_9b", 3)])
def test_reference_grow_fault_and_the_port_serving_there(name, prompt,
                                                        one_thread):
    """The reference's ``grow`` pads the reduced mamba2's SSM state (16
    heads) at a 16-token prompt, and its decode raises; it pads
    recurrentgemma's conv states (3 inputs) at a 3-token prompt, and its
    decode reads zeros for the conv's inputs, leaving its own forward.
    The port serves both: its decode, teacher-forced on its ids, equals
    its forward over the prompt and the ids."""
    from repro_torch.models import transformer as T

    cfg, tcfg, jp, tp, toks, _ = _model(name, prompt=prompt)
    if name == "mamba2_13b":
        with pytest.raises(TypeError, match="incompatible shapes"):
            _reference_loop(jp, cfg, toks)
    else:
        ids, steps, _ = _reference_loop(jp, cfg, toks)
        full = np.asarray(JT.forward_train(jp, {"tokens": jnp.asarray(
            np.concatenate([toks, ids[:, :DECODE]], 1))}, cfg))
        worst = max(float(np.abs(steps[i + 1][:, 0] - full[:, prompt + i])
                          .max() / np.abs(full[:, prompt + i]).max())
                    for i in range(DECODE))
        assert worst > 1e-2
    gen = serve.generate(tp, torch.from_numpy(toks), tcfg, DECODE)
    seq = torch.from_numpy(np.concatenate([toks, gen.ids[:, :DECODE]], 1))
    with torch.no_grad():
        full = T.forward_train(tp, {"tokens": seq}, tcfg)
        _, cache = T.forward_prefill(tp, {"tokens": seq[:, :prompt]}, tcfg)
        cache = serve.grow_cache(cache, prompt, prompt + DECODE)
        for i in range(DECODE):
            lg, cache = T.forward_decode(tp, {
                "token": seq[:, prompt + i:prompt + i + 1],
                "pos": prompt + i, "cache": cache}, tcfg)
            _close(lg[:, 0].numpy(), full[:, prompt + i].numpy())


@pytest.mark.parametrize("window,workers", [(0, 1), (3, 1), (0, 2), (3, 2)])
def test_generate_analytics_equal_the_reference_loop(window, workers,
                                                     one_thread):
    """--worp-topk 5: the aggregated per-request sample of the port's
    serving loop has the reference's keys, unbounded (prompt included) and
    over a window of 3 steps with retractions, on 1 and 2 workers."""
    cfg, tcfg, jp, tp, toks, _ = _model("gemma2_2b", seed=4)
    want_ids, _, want = _reference_loop(jp, cfg, toks, k=5, window=window,
                                        workers=workers)
    engines = serve.make_worker_engines(
        EngineConfig(**_engine_cfg(tcfg, 5)), workers, device="cpu")
    gen = serve.generate(tp, torch.from_numpy(toks), tcfg, DECODE, engines,
                         window)
    assert np.array_equal(gen.ids, want_ids)
    got = serve.sample_aggregated(engines, 5)
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_allclose(got.freqs.numpy(), np.asarray(want.freqs),
                               rtol=1e-5)


def test_main_runs_end_to_end_on_the_cpu(capsys, one_thread):
    out = serve.main(["--arch", "gemma2_2b", "--reduced", "--device", "cpu",
                      "--tokens", "4", "--batch", "2", "--prompt-len", "16",
                      "--worp-topk", "5", "--workers", "2",
                      "--worp-window", "3", "--plane", "async"])
    assert out.gen.ids.shape == (2, 5)
    assert out.gen.ids.max() < tbase.get_config("gemma2_2b").reduced(
    ).padded_vocab()
    assert tuple(out.sample.keys.shape) == (2, 5)
    text = capsys.readouterr().out
    assert "generated ids:" in text and "2 workers" in text
    assert "last 3 decode steps" in text


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "mamba2_13b",
                                  "recurrentgemma_9b", "phi3_vision_42b"])
def test_main_serves_every_decoder_family(name, capsys, one_thread):
    """The CLI at its defaults (batch 4, a 64-token prompt, 16 tokens),
    reduced, on the CPU, with --worp-topk 5."""
    out = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                      "--worp-topk", "5"])
    assert out.gen.ids.shape == (4, 17)
    assert 0 <= out.gen.ids.min() and out.gen.ids.max() < tbase.get_config(
        name).reduced().padded_vocab()
    assert tuple(out.sample.keys.shape) == (4, 5)
    assert "per-request top-5 tokens" in capsys.readouterr().out


def test_main_refuses_families_not_ported():
    """The enc-dec family exits with the reference's message."""
    with pytest.raises(SystemExit, match="enc-dec driver"):
        serve.main(["--arch", "seamless_m4t_large_v2", "--reduced",
                    "--device", "cpu"])
