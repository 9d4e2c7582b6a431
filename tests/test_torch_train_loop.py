"""The port's training loop and launcher (``repro_torch.train.loop``,
``repro_torch.launch.train``) against the JAX package's, on the CPU.

Mirrors ``tests/test_system.py::TestTrainingLoop`` (the loss decreases,
async analytics equal sparse analytics, a restart reaches the
uninterrupted run's final loss within rel 1e-4), then holds the port to
the reference across packages.  Both loops read the same ``ZipfStream``,
so the token analytics see the same tokens: the port's ``top_tokens`` keys
must be the reference's exactly, their frequencies within rtol 1e-5 (one
flush of one-pass estimates, inverted through a power; the tables differ
by the transform's ulps).  The parameters cannot be drawn alike
(``jax.random`` is not reproducible in torch), so for the losses the
reference's loop inits in float32 and the port's loop gets those
parameters carried across (``init_params`` patched in both); its 8
losses must equal the reference's within rtol 1e-4, the restart's
tolerance (measured: up to 4e-7 over the first 3 steps, as in
``tests/test_torch_train.py``, growing to 4.1e-5 by step 8 as AdamW's
normalised steps amplify the gradients' rounding).  A checkpoint the
reference's loop wrote after 4 steps, resumed by the port's, must reach
the reference's final loss of 8 uninterrupted steps within rel 1e-4.
Models run reduced.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config
from repro.models import model as JM
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.distributed import pytree
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.train import checkpoint, loop

jax.config.update("jax_platform_name", "cpu")

QUIET = dict(log_every=100, print_fn=lambda s: None)
CROSS = dict(batch=2, seq=32, lr=1e-3, analytics_sampler="onepass",
             analytics_topk=8, **QUIET)
CROSS_ARCH = "phi4_mini_38b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _tcfg(name):
    return tbase.get_config(name).reduced()


# ---------------------------------------------------------------------------
# the reference's TestTrainingLoop, on the port
# ---------------------------------------------------------------------------

def test_loss_decreases():
    out = loop.run_training(_tcfg("phi4_mini_38b"), num_steps=12, batch=4,
                            seq=64, lr=1e-3, device="cpu", **QUIET)
    losses = out["losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_token_analytics_plane_parity():
    """Token analytics through the async plane equal the sync sparse plane
    bit for bit (drained at the final sample)."""
    kw = dict(num_steps=4, batch=2, seq=32, lr=1e-3, device="cpu",
              analytics_sampler="onepass", analytics_topk=8, **QUIET)
    a = loop.run_training(_tcfg("phi4_mini_38b"), analytics_plane="async",
                          **kw)
    b = loop.run_training(_tcfg("phi4_mini_38b"), analytics_plane="sparse",
                          **kw)
    assert a["top_tokens"] == b["top_tokens"] and len(a["top_tokens"]) == 8


def test_checkpoint_restart_exact(tmp_path):
    """Crash/restart: the resumed run's final loss is the uninterrupted
    run's (deterministic data + the saved optimizer state)."""
    cfg = _tcfg("mamba2_13b")
    kw = dict(batch=2, seq=32, lr=1e-3, device="cpu", **QUIET)
    full = loop.run_training(cfg, num_steps=8, **kw)
    d = str(tmp_path / "ck")
    loop.run_training(cfg, num_steps=4, ckpt_dir=d, ckpt_every=100, **kw)
    resumed = loop.run_training(cfg, num_steps=8, ckpt_dir=d,
                                ckpt_every=100, **kw)
    assert len(resumed["losses"]) == 4
    assert resumed["final_loss"] == pytest.approx(full["final_loss"],
                                                  rel=1e-4)


def test_analytics_producers_validated():
    with pytest.raises(ValueError, match="analytics_producers"):
        loop.run_training(_tcfg("mamba2_13b"), num_steps=1, batch=1, seq=8,
                          device="cpu", analytics_producers=0, **QUIET)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's loop on float32 weights from ``PRNGKey(0)``: 8 steps
    with token analytics, and 4 steps writing a checkpoint; the float32
    weights as numpy."""
    cfg = get_config(CROSS_ARCH).reduced()
    init = JM.init_params
    weights = jax.tree_util.tree_map(
        np.asarray, init(cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    ckpt = str(tmp_path_factory.mktemp("reference_ckpt"))
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(JM, "init_params",
                       lambda cfg, key, dtype=None: init(cfg, key,
                                                         jnp.float32))
        full = jloop.run_training(cfg, num_steps=8, **CROSS)
        jloop.run_training(cfg, num_steps=4, ckpt_dir=ckpt, ckpt_every=100,
                           **CROSS)
    return {"full": full, "ckpt": ckpt, "weights": weights}


def _carried(monkeypatch, weights):
    """The port's loop starting from the reference's weights."""
    monkeypatch.setattr(
        M, "init_params",
        lambda cfg, generator, dtype=None, device=None:
        convert.params_from_numpy(weights, device))


def test_losses_and_top_tokens_match_reference(reference, monkeypatch):
    _carried(monkeypatch, reference["weights"])
    out = loop.run_training(_tcfg(CROSS_ARCH), num_steps=8, device="cpu",
                            **CROSS)
    want = reference["full"]
    np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-4)
    assert [t for t, _ in out["top_tokens"]] == \
        [t for t, _ in want["top_tokens"]]
    np.testing.assert_allclose([f for _, f in out["top_tokens"]],
                               [f for _, f in want["top_tokens"]],
                               rtol=1e-5)
    assert all(p.dtype == torch.float32
               for p in pytree.leaves(out["state"].params))


def test_top_tokens_keys_match_reference_from_own_weights(reference):
    """The token stream does not depend on the weights: the port's loop on
    its own bfloat16 weights samples the reference's keys."""
    out = loop.run_training(_tcfg(CROSS_ARCH), num_steps=8, device="cpu",
                            **CROSS)
    assert [t for t, _ in out["top_tokens"]] == \
        [t for t, _ in reference["full"]["top_tokens"]]


def test_reference_checkpoint_resumes_in_the_port(reference, monkeypatch):
    """A checkpoint the reference's loop wrote at step 3 (its leaf keys
    ``params.*``, ``opt.step``, ``opt.mu.*``, ``opt.nu.*``) resumes in the
    port's loop, which reaches the reference's final loss."""
    _carried(monkeypatch, reference["weights"])
    lines = []
    out = loop.run_training(_tcfg(CROSS_ARCH), num_steps=8,
                            ckpt_dir=reference["ckpt"], ckpt_every=100,
                            device="cpu", **{**CROSS,
                                             "print_fn": lines.append})
    assert "[ckpt] resumed from step 3" in lines
    assert len(out["losses"]) == 4
    assert out["final_loss"] == pytest.approx(
        reference["full"]["final_loss"], rel=1e-4)
    assert int(out["state"].opt.step) == 8


def test_checkpoint_leaf_keys_are_the_reference_layout(tmp_path):
    cfg = _tcfg("mamba2_13b")
    d = str(tmp_path / "ck")
    out = loop.run_training(cfg, num_steps=2, batch=1, seq=16, ckpt_dir=d,
                            device="cpu", **QUIET)
    step = checkpoint.latest_step(d)
    assert step == 1
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        keys = set(json.load(f)["leaves"])
    want = {"opt.step"} | {
        f"{top}.{k}" for top in ("params", "opt.mu", "opt.nu")
        for k in ("embed", "final_norm")}
    assert want <= keys
    assert len(keys) == 1 + 3 * len(pytree.leaves(out["state"].params))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compressed", [False, True],
                         ids=["plain", "compressed"])
def test_cli_trains_on_the_cpu(compressed, capsys):
    argv = ["--arch", "mamba2_13b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "32", "--device", "cpu"]
    out = launch_train.main(argv + (["--compressed"] if compressed else []))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert hasattr(out["state"], "error") == compressed
    assert not dist.is_initialized()  # the launcher's group is torn down
    assert "done: final loss" in capsys.readouterr().out
