"""The port's training steps and elastic helpers (``repro_torch.train.steps``,
``repro_torch.train.elastic``) against the JAX package's, on the CPU.

Parameters are the reference's own, initialized in float32 by
``init_params(cfg, PRNGKey(0), dtype=float32)`` and carried across as numpy
(``convert.params_from_numpy``); batches are the reference's ``ZipfStream``
(numpy, the same in both packages).  The reference's steps run under
``jax.jit``, its compressed steps over a ``(1,)`` mesh; the port's over a
one-rank gloo group (a ``FileStore`` under the test's ``tmp_path``).
Models run reduced (2 layers, d_model 128, vocabulary 512), float32.

Tolerances (both packages sum products, softmaxes and backward passes in
their own orders, so gradients agree to ~1e-3 of their leaf's scale,
``tests/test_torch_models.py``, and AdamW's normalised step turns a
gradient of rounding size into a step of up to ``lr``):
  * losses: rtol 1e-5 (measured up to 4.7e-7 over 3 steps);
  * parameters after 3 ``train_step``s: every element within
    ``lr x steps`` (measured up to 0.2 x that, olmoe), and the 99.9th
    percentile of |diff| within 1e-5 (measured up to 2.8e-6);
  * moments: each leaf within 1e-2 x its max|want| (measured up to 2.0e-3
    x), and the 99.9th percentile of |diff| within 1e-4 (measured up to
    3.0e-5);
  * the compressed steps: the sampled support (where the error feedback
    is zero) bit for bit, the loss rtol 1e-5, parameters, moments and
    error trees as above;
  * two spawned gloo ranks, each on its own rows: parameters equal on both
    ranks bit for bit, the step's loss the mean of the ranks' losses on
    their own rows within rtol 1e-6.
"""
import math
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import get_config
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import gradcomp as JG
from repro.train import elastic as jelastic
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data.pipeline import ZipfStream
from repro_torch.distributed import pytree
from repro_torch.distributed import sharding as tshd
from repro_torch.models import model as M
from repro_torch.models.params import leaves as P_leaves
from repro_torch.optim import adamw
from repro_torch.optim import gradcomp as G
from repro_torch.train import elastic, steps

jax.config.update("jax_platform_name", "cpu")

LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-5
Q999_PARAMS, Q999_MOMENTS, MOMENT_SCALE = 1e-5, 1e-4, 1e-2
GLOO_TIMEOUT_S = 180.0
CC = dict(k=64, rows=5, width=2048, candidates=256, p=1.0, mode="twopass")


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


def _configs(name):
    return get_config(name).reduced(), tbase.get_config(name).reduced()


def _params(cfg, seed=0):
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _batch(cfg, step, batch=2, seq=32):
    """Step ``step``'s next-token batch of the reference's Zipf stream, for
    both packages."""
    toks = ZipfStream(cfg.vocab_size, 1.2, 0).batch_at(step, 0, batch,
                                                       seq + 1)
    arrays = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flat(tree, jax_tree: bool):
    leaves = jax.tree_util.tree_leaves(tree) if jax_tree \
        else pytree.leaves(tree)
    return [_np(x) for x in leaves]


def _assert_tree_close(what, jtree, ttree, atol=None, scale=None, q999=None):
    want, got = _flat(jtree, True), _flat(ttree, False)
    assert len(want) == len(got), what
    diffs = []
    for w, g in zip(want, got):
        assert w.shape == g.shape and w.dtype == g.dtype, what
        d = np.abs(g.astype(np.float64) - w)
        diffs.append(d.ravel())
        if atol is not None:
            assert d.max() <= atol, (what, d.max(), atol)
        if scale is not None:
            assert d.max() <= scale * max(float(np.abs(w).max()), 1e-30), \
                (what, d.max(), float(np.abs(w).max()))
    if q999 is not None:
        q = float(np.quantile(np.concatenate(diffs), 0.999))
        assert q <= q999, (what, q, q999)


def _assert_states_close(js, ts, steps_taken):
    _assert_tree_close("params", js.params, ts.params,
                       atol=LR * steps_taken, q999=Q999_PARAMS)
    for what in ("mu", "nu"):
        _assert_tree_close(what, getattr(js.opt, what),
                           getattr(ts.opt, what), scale=MOMENT_SCALE,
                           q999=Q999_MOMENTS)
    assert int(js.opt.step) == int(ts.opt.step) == steps_taken


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["phi4_mini_38b", "mamba2_13b",
                                  "olmoe_1b_7b"])
def test_train_step_matches_reference(name):
    cfg, tcfg = _configs(name)
    jp, tp = _params(cfg)
    js = JS.TrainState(jp, jadamw.init(jp))
    ts = steps.TrainState(tp, adamw.init(tp))
    jstep = jax.jit(lambda s, b: JS.train_step(s, b, cfg, lr=LR))
    for i in range(STEPS):
        jb, tb = _batch(cfg, i)
        js, jm = jstep(js, jb)
        ts, tm = steps.train_step(ts, tb, tcfg, lr=LR)
        assert tm["loss"].dtype == torch.float32
        assert not tm["loss"].requires_grad
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    _assert_states_close(js, ts, STEPS)


def test_value_and_grad_keeps_the_parameters_dtype():
    """Gradients in each parameter's dtype (bfloat16 weights give bfloat16
    gradients, as ``jax.value_and_grad``), the parameters untouched."""
    _, tcfg = _configs("mamba2_13b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    before = [x.clone() for x in pytree.leaves(params)]
    _, tb = _batch(tcfg, 0)
    loss, grads = steps.value_and_grad(params, tb, tcfg)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for p, g, b in zip(pytree.leaves(params), pytree.leaves(grads), before):
        assert g.dtype == p.dtype == torch.bfloat16 and g.shape == p.shape
        assert not p.requires_grad and torch.equal(p, b)


def test_serve_steps_match_the_model():
    _, tcfg = _configs("phi4_mini_38b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    _, tb = _batch(tcfg, 0, seq=16)
    logits, cache = steps.serve_prefill(params, {"tokens": tb["tokens"]},
                                        tcfg)
    want, _ = M.prefill(params, {"tokens": tb["tokens"]}, tcfg)
    assert torch.equal(logits, want.detach()) and not logits.requires_grad
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    out, _ = steps.serve_step(params, {"token": tok, "pos": 15,
                                       "cache": cache}, tcfg)
    assert out.shape == (2, 1, tcfg.padded_vocab())
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the compressed steps
# ---------------------------------------------------------------------------

def _support(error_tree, jax_tree):
    return [x == 0 for x in _flat(error_tree, jax_tree)]


@pytest.mark.parametrize("tp", [False, True], ids=["flat", "sharded"])
def test_compressed_steps_match_reference(group, tp):
    cfg, tcfg = _configs("mamba2_13b")
    jp, tparams = _params(cfg)
    err = (lambda p: jnp.zeros((1,) + p.shape, jnp.float32)) if tp \
        else (lambda p: jnp.zeros(p.shape, jnp.float32))
    js = JS.CompressedTrainState(jp, jadamw.init(jp),
                                 jax.tree_util.tree_map(err, jp))
    terr = G.init_error(tparams)
    if tp:
        terr = pytree.tree_map(lambda e: e[None], terr)
    ts = steps.CompressedTrainState(tparams, adamw.init(tparams), terr)
    mesh = jax.make_mesh((1,), ("data",))
    build = JS.make_compressed_train_step_tp if tp \
        else JS.make_compressed_train_step
    jstep = jax.jit(build(cfg, mesh, JG.CompressorConfig(**CC), lr=LR))
    tbuild = steps.make_compressed_train_step_tp if tp \
        else steps.make_compressed_train_step
    tstep = tbuild(tcfg, group, G.CompressorConfig(**CC), lr=LR)
    for i in range(2):
        jb, tb = _batch(cfg, i)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert sorted(jm) == sorted(tm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        for key in jm:
            if key not in ("loss", "tau"):
                assert float(tm[key]) == float(jm[key]), key
        for a, b in zip(_support(js.error, True), _support(ts.error, False)):
            assert np.array_equal(a, b)
    assert ("tau" in tm) == (not tp)
    assert sum(int(s.sum()) for s in _support(ts.error, False)) >= CC["k"]
    _assert_tree_close("error", js.error, ts.error, scale=MOMENT_SCALE,
                       q999=Q999_MOMENTS)
    _assert_states_close(js, ts, 2)


def test_compressed_step_on_bfloat16_weights_keeps_float32_error(group):
    """A bfloat16 model's sparse update and error feedback come back in
    float32 (the reference's single-dtype ``ravel_pytree`` inverse keeps
    the vector's dtype), the parameters bfloat16."""
    _, tcfg = _configs("mamba2_13b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = steps.CompressedTrainState(params, adamw.init(params),
                                       G.init_error(params))
    step = steps.make_compressed_train_step(tcfg, group,
                                            G.CompressorConfig(**CC))
    _, tb = _batch(tcfg, 0)
    state, m = step(state, tb)
    assert all(e.dtype == torch.float32 for e in pytree.leaves(state.error))
    assert all(p.dtype == torch.bfloat16 for p in pytree.leaves(state.params))
    zeros = sum(int((e == 0).sum()) for e in pytree.leaves(state.error))
    assert zeros >= CC["k"] and torch.isfinite(m["loss"])


def test_compressed_steps_raise_without_a_group():
    _, tcfg = _configs("mamba2_13b")
    for build in (steps.make_compressed_train_step,
                  steps.make_compressed_train_step_tp):
        with pytest.raises(RuntimeError, match="process group"):
            build(tcfg, None, G.CompressorConfig(**CC))


def test_local_rows_split_the_batch():
    b = {"tokens": torch.arange(12).reshape(4, 3)}
    assert torch.equal(steps.local_rows(b, 1, 2)["tokens"],
                       torch.arange(6, 12).reshape(2, 3))
    with pytest.raises(ValueError, match="split"):
        steps.local_rows(b, 0, 3)


TWO_RANK_BATCH = 4


def _two_rank_params():
    _, tcfg = _configs("mamba2_13b")
    return tcfg, M.init_params(tcfg, torch.Generator().manual_seed(5),
                               dtype=torch.float32, device="cpu")


def _gloo_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        tcfg, params = _two_rank_params()
        state = steps.CompressedTrainState(params, adamw.init(params),
                                           G.init_error(params))
        step = steps.make_compressed_train_step(tcfg, None,
                                                G.CompressorConfig(**CC))
        losses, error = [], None
        for i in range(2):
            _, tb = _batch(tcfg, i, batch=TWO_RANK_BATCH)
            state, m = step(state, tb)
            losses.append(float(m["loss"]))
            if error is None:
                error = np.concatenate([e.numpy().ravel() for e in
                                        pytree.leaves(state.error)])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 *[p.numpy() for p in pytree.leaves(state.params)],
                 losses=np.asarray(losses))
        np.save(os.path.join(out_dir, f"error{rank}.npy"), error)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_take_their_own_rows(tmp_path):
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
    for key in got[0]:
        assert got[0][key].tobytes() == got[1][key].tobytes(), key
    # after step 1 each rank's error feedback is the gradient of its OWN
    # rows, zeroed at the sampled ids (the same ids on both ranks)
    tcfg, params = _two_rank_params()
    _, tb = _batch(tcfg, 0, batch=TWO_RANK_BATCH)
    own, sampled = [], []
    for r in range(world):
        loss, grads = steps.value_and_grad(
            params, steps.local_rows(tb, r, world), tcfg)
        own.append(float(loss))
        g = np.concatenate([x.numpy().ravel() for x in pytree.leaves(grads)])
        err = np.load(tmp_path / f"error{r}.npy")
        kept = err != 0
        sampled.append(~kept & (g != 0))
        assert sampled[-1].sum() >= CC["k"] // 2
        np.testing.assert_allclose(err[kept], g[kept], rtol=1e-6, atol=0)
    assert (sampled[0] | sampled[1]).sum() <= CC["k"]
    assert own[0] != own[1]
    np.testing.assert_allclose(got[0]["losses"][0], np.mean(own), rtol=1e-6)


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

class TestStragglerWatchdog:
    def test_flags_outlier(self):
        w = elastic.StragglerWatchdog(threshold=2.0, warmup_steps=1)
        for step in range(6):
            w.step_begin()
            time.sleep(0.01 if step != 4 else 0.08)
            w.step_end(step)
        assert [f[0] for f in w.flagged] == [4]

    def test_baseline_not_poisoned(self):
        w = elastic.StragglerWatchdog(threshold=2.0, warmup_steps=1)
        w.step_begin(); time.sleep(0.01); w.step_end(0)  # noqa: E702
        w.step_begin(); time.sleep(0.01); w.step_end(1)  # noqa: E702
        base = w.ewma
        w.step_begin(); time.sleep(0.1); w.step_end(2)  # noqa: E702
        assert w.ewma == base  # outlier did not move the EWMA

    def test_callback_and_warmup_match_reference(self, monkeypatch):
        """The same scripted step times flag the same steps, call back with
        the same arguments and end on the same baseline in both packages
        (the clock replaced)."""
        times = [0.01, 0.01, 0.05, 0.01, 0.01, 0.08, 0.01, 0.2, 0.01]

        def run(mod):
            ticks = iter(np.cumsum([0.0] + [x for t in times
                                            for x in (t, 0.0)]))
            monkeypatch.setattr(mod, "time", types.SimpleNamespace(
                monotonic=lambda: float(next(ticks))))
            calls = []
            w = mod.StragglerWatchdog(
                threshold=2.0, warmup_steps=2,
                on_straggler=lambda *a: calls.append(a))
            for step in range(len(times)):
                w.step_begin()
                w.step_end(step)
            return calls, w.flagged, w.ewma

        want, got = run(jelastic), run(elastic)
        assert got == want
        assert [f[0] for f in got[1]] == [2, 5, 7]


def test_plan_remesh_axes_match_reference():
    for args in ((8, 2), (4, 4), (16, 2, 2), (1, 1)):
        mesh = elastic.plan_remesh(*args, device="cpu")
        per_pod = args[0] // (args[2] if len(args) > 2 else 1)
        want = (("pod",) if len(args) > 2 else ()) + ("data", "model")
        assert mesh.axis_names == want
        assert mesh.shape["data"] == per_pod // args[1]
        assert mesh.shape["model"] == args[1]
        assert math.prod(mesh.shape.values()) == args[0]
    jm = jelastic.plan_remesh(1, 1)
    assert dict(jm.shape) == elastic.plan_remesh(1, 1, device="cpu").shape
    with pytest.raises(ValueError, match="split"):
        elastic.plan_remesh(6, 4, device="cpu")


def test_reshard_tree_resolves_specs_against_the_mesh():
    """A checkpoint's numpy tree onto a (data 2, model 4) mesh: every leaf
    on the mesh's device with the model's specs, as the reference's
    ``resolve_pspec`` gives them; a spec naming an absent axis or not
    dividing its dimension raises."""
    _, tcfg = _configs("phi4_mini_38b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    mesh = elastic.plan_remesh(8, 4, device="cpu")
    specs = M.param_pspecs(tcfg, mesh)
    host = convert.params_to_numpy(params)
    out = elastic.reshard_tree(host, mesh, specs)
    for a, b in zip(pytree.leaves(out), pytree.leaves(params)):
        assert a.device.type == "cpu"
        assert torch.equal(a.to(b.dtype), b)
    assert any(s is not None and any(s) for s in P_leaves(specs))
    tshd.set_mesh(mesh)
    try:
        assert tshd.get_mesh().shape == {"data": 2, "model": 4}
    finally:
        tshd.set_mesh(None)
    with pytest.raises(ValueError, match="absent"):
        elastic.reshard_tree({"w": np.zeros((4, 4))}, mesh,
                             {"w": (("pod",), None)})
    with pytest.raises(ValueError, match="divide"):
        elastic.reshard_tree({"w": np.zeros((6, 4))}, mesh,
                             {"w": (None, ("data", "model"))})
