"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's (``repro.train.checkpoint``), on the CPU.

* A state carried across by ``convert.py`` and saved by both packages under
  the same codec gives byte-identical files (every ``.npy`` and
  ``manifest.json``), for every sampler's state, the ``{"state", "pass2"}``
  dict and a bfloat16 leaf, under all five codecs.
* A checkpoint written by either package restores in the other, and the
  next ``sample`` and ``update`` are identical (bit for bit within a
  package, the same sample keys across the two).
* The reference's behaviour: atomic commit, the newest committed step wins,
  ``.tmp`` residue is ignored and collected, the CRC rejects a flipped
  byte (raw and encoded), lossless codecs restore bit for bit and lossy
  ones within the codec's bound, ``payload_nbytes`` is the reference's and
  ``tree_nbytes``, and ``restore`` with no card raises unless the caller
  asks for the CPU.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.distributed import codecs as JC
from repro.train import checkpoint as jcheckpoint
from repro_torch import convert
from repro_torch.core import worp
from repro_torch.distributed import codecs as C
from repro_torch.distributed import pytree
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.train import checkpoint

jax.config.update("jax_platform_name", "cpu")

SAMPLERS = ("onepass", "twopass", "perfect", "tv")


def _cfg(name):
    return dict(num_streams=3, rows=3, width=128, candidates=16, capacity=16,
                p=1.0, seed=11, sampler=name, domain=600, num_samplers=3)


def _data():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 500, (3, 40)).astype(np.int32),
            rng.normal(size=(3, 40)).astype(np.float32))


def _engines(name):
    """A JAX engine after one flush and a port engine holding its state."""
    keys, vals = _data()
    jeng = JE.SketchEngine(JE.EngineConfig(**_cfg(name)))
    jeng.ingest(keys, vals)
    jeng.flush()
    eng = SketchEngine(EngineConfig(**_cfg(name)), device="cpu")
    eng.state = convert.state_from_numpy(
        type(eng.state),
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jeng.state)],
        "cpu")
    return jeng, eng


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


def _assert_port_equal(a, b):
    la, lb = pytree.leaves(a), pytree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert _bits(C.to_host(x)) == _bits(C.to_host(y))


def _jax_tree(like, port_tree):
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                        convert.tree_to_numpy(port_tree))


# ---------------------------------------------------------------------------
# the reference's files, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", C.available_codecs())
@pytest.mark.parametrize("name", SAMPLERS)
def test_files_byte_identical(tmp_path, name, codec):
    jeng, eng = _engines(name)
    got = checkpoint.save(str(tmp_path / "port"), 5, eng.state,
                          extra={"sampler": name}, codec=codec)
    want = jcheckpoint.save(str(tmp_path / "jax"), 5, jeng.state,
                            extra={"sampler": name}, codec=codec)
    assert os.path.basename(got) == os.path.basename(want) == "step_000000005"
    assert _files(got) == _files(want)
    assert checkpoint.payload_nbytes(got) == jcheckpoint.payload_nbytes(want) \
        == C.tree_nbytes(eng.state, codec)


@pytest.mark.parametrize("codec", ["none", "q8"])
def test_pass2_dict_files_and_keys(tmp_path, codec):
    """``{"state", "pass2"}``: ``pass2.*`` before ``state.*`` (JAX sorts
    dict keys), byte-identical files, and each package restores the
    other's into its own tree."""
    jeng, eng = _engines("onepass")
    jeng.freeze()
    keys, vals = _data()
    jeng.update_pass2(keys, np.abs(vals))
    eng.pass2 = convert.state_from_numpy(
        worp.TwoPassState,
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jeng.pass2)], "cpu")
    tree = {"state": eng.state, "pass2": eng.pass2}
    jtree = {"state": jeng.state, "pass2": jeng.pass2}
    got = checkpoint.save(str(tmp_path / "port"), 1, tree, codec=codec)
    want = jcheckpoint.save(str(tmp_path / "jax"), 1, jtree, codec=codec)
    assert _files(got) == _files(want)
    with open(os.path.join(got, "manifest.json")) as f:
        order = list(json.load(f)["leaves"])
    assert order == ["pass2.keys", "pass2.freqs", "pass2.priority",
                     "pass2.seed_transform", "state.sketch.table",
                     "state.sketch.seed", "state.cand_keys",
                     "state.seed_transform"]
    kinds = {"state": worp.OnePassState, "pass2": worp.TwoPassState}
    back = checkpoint.restore(str(tmp_path / "jax"), 1, tree, device="cpu")
    assert list(back) == ["pass2", "state"]
    _assert_port_equal(back, convert.tree_from_numpy(
        kinds, convert.tree_to_numpy(C.get_codec(codec).roundtrip(tree)),
        "cpu"))
    jback = jcheckpoint.restore(str(tmp_path / "port"), 1, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    convert.tree_to_numpy(back)):
        assert _bits(np.asarray(a)) == _bits(b)


def test_bfloat16_leaf_across_packages(tmp_path):
    """A bfloat16 leaf is written raw with dtype ``"bfloat16"`` and read back
    without ``ml_dtypes`` in the port; the reference reads the port's file
    and the port the reference's."""
    rng = np.random.default_rng(1)
    w = torch.tensor(rng.normal(size=(4, 6)) * 30, dtype=torch.bfloat16)
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    for codec in ("none", "q8"):
        got = checkpoint.save(str(tmp_path / f"p{codec}"), 1, {"w": w},
                              codec=codec)
        want = jcheckpoint.save(str(tmp_path / f"j{codec}"), 1, {"w": jw},
                                codec=codec)
        assert _files(got) == _files(want)
        with open(os.path.join(got, "manifest.json")) as f:
            assert json.load(f)["leaves"]["w"]["dtype"] == "bfloat16"
        back = checkpoint.restore(str(tmp_path / f"j{codec}"), 1, {"w": w},
                                  device="cpu")["w"]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), w.view(torch.int16))
        jback = jcheckpoint.restore(str(tmp_path / f"p{codec}"), 1,
                                    {"w": jw})["w"]
        assert np.array_equal(np.asarray(jback).view(np.uint16),
                              C.to_host(w))


# ---------------------------------------------------------------------------
# restore across packages, then keep going
# ---------------------------------------------------------------------------

def _assert_samples_equal(a, b):
    for x, y in zip(a, b):
        assert _bits(x.numpy()) == _bits(y.numpy())


@pytest.mark.parametrize("name", SAMPLERS)
def test_jax_checkpoint_restores_in_port(tmp_path, name):
    """The reference writes; the port restores into a fresh engine.  Its
    state, next sample and next update equal those of the port engine that
    carried the state across by ``convert.py``, bit for bit, and the sample
    keys are the reference's."""
    jeng, eng = _engines(name)
    jcheckpoint.save(str(tmp_path), 5, jeng.state, extra={"sampler": name})
    fresh = SketchEngine(EngineConfig(**_cfg(name)), device="cpu")
    restored, step = checkpoint.restore_latest(str(tmp_path), fresh.state,
                                               device="cpu")
    assert step == 5
    _assert_port_equal(restored, eng.state)
    fresh.state = restored
    _assert_samples_equal(fresh.sample(4), eng.sample(4))
    assert np.array_equal(fresh.sample(4).keys.numpy(),
                          np.asarray(jeng.sample(4).keys))
    keys, vals = _data()
    fresh.update(keys[:, :8], vals[:, :8])
    eng.update(keys[:, :8], vals[:, :8])
    _assert_port_equal(fresh.state, eng.state)


@pytest.mark.parametrize("name", SAMPLERS)
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    """The port writes; the reference restores.  Its state, next sample and
    next update equal those of the JAX engine that carried the port's state
    across, bit for bit."""
    jeng, eng = _engines(name)
    eng.update(*(x[:, :8] for x in _data()))  # a state of the port's own
    checkpoint.save(str(tmp_path), 2, eng.state)
    fresh = JE.SketchEngine(JE.EngineConfig(**_cfg(name)))
    restored, step = jcheckpoint.restore_latest(str(tmp_path), fresh.state)
    assert step == 2
    carried = _jax_tree(jeng.state, eng.state)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(carried)):
        assert _bits(np.asarray(a)) == _bits(np.asarray(b))
    fresh.state = restored
    jeng.state = carried
    for a, b in zip(fresh.sample(4), jeng.sample(4)):
        assert _bits(np.asarray(a)) == _bits(np.asarray(b))
    assert np.array_equal(np.asarray(fresh.sample(4).keys),
                          eng.sample(4).keys.numpy())
    keys, vals = _data()
    fresh.update(keys[:, 8:16], vals[:, 8:16])
    jeng.update(keys[:, 8:16], vals[:, 8:16])
    for a, b in zip(jax.tree_util.tree_leaves(fresh.state),
                    jax.tree_util.tree_leaves(jeng.state)):
        assert _bits(np.asarray(a)) == _bits(np.asarray(b))


# ---------------------------------------------------------------------------
# the reference's behaviour
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    checkpoint.save(str(tmp_path), 7, tree)
    out, step = checkpoint.restore_latest(str(tmp_path), tree, device="cpu")
    assert step == 7
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32


def test_latest_wins_tmp_ignored_and_collected(tmp_path):
    for pkg, zeros, ones, d in ((checkpoint, torch.zeros(3), torch.ones(3),
                                 tmp_path / "port"),
                                (jcheckpoint, jnp.zeros(3), jnp.ones(3),
                                 tmp_path / "jax")):
        pkg.save(str(d), 1, {"x": zeros})
        pkg.save(str(d), 5, {"x": ones})
        os.makedirs(d / "step_000000009.tmp")  # crash residue
        os.makedirs(d / "step_000000011")      # no manifest: not committed
        assert pkg.latest_step(str(d)) == 5
        pkg.gc_tmp(str(d))
        assert not (d / "step_000000009.tmp").exists()
        assert (d / "step_000000011").exists()
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    assert checkpoint.restore_latest(str(tmp_path / "none"),
                                     {"x": torch.zeros(3)}) == (None, None)
    out, step = checkpoint.restore_latest(str(tmp_path / "jax"),
                                          {"x": torch.zeros(3)}, device="cpu")
    assert step == 5 and float(out["x"][0]) == 1.0


@pytest.mark.parametrize("codec", ["none", "q8"])
def test_crc_rejects_a_flipped_byte(tmp_path, codec):
    tree = {"w": torch.arange(100.0) * 7.5}
    path = checkpoint.save(str(tmp_path), 3, tree, codec=codec)
    fn = os.path.join(path, "w.npy")
    arr = np.load(fn)  # the (encoded) uint8 wire image
    arr[0] ^= 0xFF
    np.save(fn, arr)
    with pytest.raises(IOError):
        checkpoint.restore(str(tmp_path), 3, tree, device="cpu")
    with pytest.raises(IOError):
        jcheckpoint.restore(str(tmp_path), 3, {"w": jnp.zeros(100)})


@pytest.mark.parametrize("codec", C.available_codecs())
@pytest.mark.parametrize("name", SAMPLERS)
def test_state_roundtrip_every_codec(tmp_path, name, codec):
    """Bit for bit under lossless codecs, within the codec's bound under
    lossy ones; the port's dtypes (int64 seeds) and the reference's
    restored values."""
    jeng, eng = _engines(name)
    checkpoint.save(str(tmp_path), 1, eng.state, codec=codec)
    fresh = SketchEngine(EngineConfig(**_cfg(name)), device="cpu")
    restored, _ = checkpoint.restore_latest(str(tmp_path), fresh.state,
                                            device="cpu")
    for a, b in zip(pytree.leaves(restored), pytree.leaves(eng.state)):
        assert a.dtype == b.dtype and a.shape == b.shape
    if codec == "none":
        _assert_port_equal(restored, eng.state)
    else:
        C.assert_trees_within_codec(restored, eng.state, codec,
                                    label=f"{name}@{codec}")
    jrestored = jcheckpoint.restore(str(tmp_path), 1, jeng.state)
    for a, b in zip(convert.tree_to_numpy(restored),
                    jax.tree_util.tree_leaves(jrestored)):
        assert _bits(a) == _bits(np.asarray(b))


def test_codec_none_writes_precodec_format(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "s": torch.zeros(2, dtype=torch.int64)}
    path = checkpoint.save(str(tmp_path), 1, tree, codec="none")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert all("codec" not in m for m in manifest["leaves"].values())
    assert manifest["leaves"]["s"]["dtype"] == "uint32"


def test_payload_nbytes_from_manifest(tmp_path):
    tree = {"w": torch.zeros((4, 1 << 12)), "s": torch.zeros(3,
                                                             dtype=torch.int64)}
    n = 4 * (1 << 12)
    p_none = checkpoint.save(str(tmp_path / "a"), 1, tree, codec="none")
    p_sa = checkpoint.save(str(tmp_path / "b"), 1, tree,
                           codec="size_adaptive")
    assert checkpoint.payload_nbytes(p_none) == 4 * n + 12
    assert checkpoint.payload_nbytes(p_sa) == (n + 4 * 4) + 12
    assert checkpoint.payload_nbytes(p_sa) == JC.tree_nbytes(
        {"w": np.zeros((4, 1 << 12), np.float32),
         "s": np.zeros(3, np.uint32)}, "size_adaptive")


def test_restore_needs_a_card_or_the_cpu_asked_for(tmp_path, monkeypatch):
    tree = {"w": torch.arange(6.0)}
    checkpoint.save(str(tmp_path), 1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore(str(tmp_path), 1, tree)
    assert torch.equal(checkpoint.restore(str(tmp_path), 1, tree,
                                          device="cpu")["w"], tree["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), 1, {"w": torch.zeros(5)},
                           device="cpu")
