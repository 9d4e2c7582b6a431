"""The port's multi-worker serving helpers (``repro_torch.launch.serve``)
against the JAX package's (``repro.launch.serve``), on the CPU.

* ``aggregate_worker_states`` over the reference's worker states (carried
  across by ``convert.py``) equals the reference's aggregate bit for bit,
  at 4 workers (the butterfly) and 3 (the tree), under ``none`` and q8.
* Fed the same round-robin decode stream, ``sample_aggregated`` gives the
  reference's sample keys and those of one engine that saw every step.
* A worker of another config (another seed) raises; so do no workers.
"""
import jax
import numpy as np
import pytest

from repro.engine import EngineConfig as JConfig
from repro.launch import serve as jserve
from repro_torch import convert
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
