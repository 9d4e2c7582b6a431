"""The port's wire codecs (``repro_torch.distributed.codecs``) against the
JAX package's (``repro.distributed.codecs``), on the CPU.

* Registry, resolution and the dtype guard mirror the reference's; int64
  seed tensors travel as raw uint32 and bfloat16 travels raw under every
  codec, as the reference's ``ml_dtypes`` bfloat16 does.
* Every leaf of every sampler's state (carried across by ``convert.py``)
  has the reference's wire image under all five codecs, bit for bit:
  kind, payload, scales, dtype and shape; so do a bfloat16 leaf and slices
  holding inf and NaN.
* Decode, ``roundtrip`` and ``fake_quant`` give the reference's values bit
  for bit (``fake_quant`` on finite inputs); ``payload_nbytes`` and
  ``tree_nbytes`` are the reference's; ``assert_trees_within_codec`` passes
  and fails where the reference's does; ``none`` returns the same object.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.distributed import codecs as JC
from repro_torch import convert
from repro_torch.distributed import codecs as C
from repro_torch.distributed import pytree
from repro_torch.engine import EngineConfig, SketchEngine

jax.config.update("jax_platform_name", "cpu")

LOSSY = ("fp16", "q8", "size_adaptive", "q2")
SAMPLERS = ("onepass", "twopass", "perfect", "tv")


def _same_image(got: C.EncodedLeaf, want) -> bool:
    if (got.kind, got.dtype, got.shape) != (want.kind, want.dtype,
                                            want.shape):
        return False
    if got.payload.dtype != np.uint8 or \
            not np.array_equal(got.payload, want.payload):
        return False
    if (got.scale is None) != (want.scale is None):
        return False
    return got.scale is None or (
        got.scale.dtype == want.scale.dtype == np.float32
        and np.array_equal(got.scale.view(np.uint32),
                           want.scale.view(np.uint32)))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.view(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# registry and dtype guard
# ---------------------------------------------------------------------------

def test_registered_names_and_order():
    assert C.available_codecs() == JC.available_codecs()
    for name in C.available_codecs():
        got, want = C.get_codec(name), JC.get_codec(name)
        assert (got.rel_step, got.clamp) == (want.rel_step, want.clamp)
        assert C.describe(name) == JC.describe(name)
    assert (C.SIZE_ADAPTIVE_THRESHOLD, C.FP16_MAX) == \
        (JC.SIZE_ADAPTIVE_THRESHOLD, JC.FP16_MAX)


def test_resolution():
    assert C.get_codec(None).name == "none"
    assert C.get_codec("q8") is C.get_codec("q8")
    inst = C.FP16Codec()
    assert C.get_codec(inst) is inst
    with pytest.raises(ValueError, match="unknown codec"):
        C.get_codec("zstd")


@pytest.mark.parametrize("codec", C.available_codecs())
@pytest.mark.parametrize("dtype", ["uint32", "int32", "bool", "seed",
                                   "bfloat16"])
def test_non_float_leaves_travel_raw(codec, dtype):
    """uint32/int32/bool arrays, int64 seed tensors and bfloat16 tensors:
    raw under every codec, with the reference's wire image of the same
    values (its seeds are uint32, its bfloat16 an ``ml_dtypes`` array)."""
    vals = np.arange(32).reshape(4, 8)
    if dtype == "seed":
        leaf = torch.tensor(vals * 0x9E3779B1 % 2**32, dtype=torch.int64)
        ref = np.asarray(leaf.numpy(), np.uint32)
    elif dtype == "bfloat16":
        leaf = torch.tensor(vals * 1.37 - 5.0, dtype=torch.bfloat16)
        ref = np.asarray(jnp.asarray(leaf.float().numpy(), jnp.bfloat16))
    elif dtype == "bool":
        leaf = ref = vals % 3 == 0
    else:
        leaf = ref = vals.astype(dtype)
    cdc, jcdc = C.get_codec(codec), JC.get_codec(codec)
    enc = cdc.encode_leaf(leaf)
    assert enc.kind == "raw"
    assert _same_image(enc, jcdc.encode_leaf(ref))
    assert cdc.payload_nbytes(leaf) == jcdc.payload_nbytes(ref) == enc.nbytes
    back = cdc.roundtrip([leaf])[0]
    if isinstance(leaf, torch.Tensor):
        assert back.dtype == leaf.dtype
        assert _bits(C.to_host(back)) == _bits(C.to_host(leaf))
    else:
        assert _bits(back) == _bits(leaf)


# ---------------------------------------------------------------------------
# wire images of every sampler's state
# ---------------------------------------------------------------------------

def _cfg(name, seed=11):
    return dict(num_streams=3, rows=3, width=128, candidates=16,
                capacity=16, p=1.0, seed=seed, sampler=name, domain=600,
                num_samplers=3)


def _jax_state(name, seed=11):
    eng = JE.SketchEngine(JE.EngineConfig(**_cfg(name, seed)))
    rng = np.random.default_rng(0)
    eng.ingest(rng.integers(0, 500, (3, 40)).astype(np.int32),
               rng.normal(size=(3, 40)).astype(np.float32))
    eng.flush()
    return eng.state


def _port_state(jst, name):
    kind = type(SketchEngine(EngineConfig(**_cfg(name)), device="cpu").state)
    return convert.state_from_numpy(
        kind, [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)], "cpu")


@pytest.mark.parametrize("codec", C.available_codecs())
@pytest.mark.parametrize("name", SAMPLERS)
def test_state_wire_images_match_reference(name, codec):
    jst = _jax_state(name)
    st = _port_state(jst, name)
    cdc, jcdc = C.get_codec(codec), JC.get_codec(codec)
    leaves, jleaves = pytree.leaves(st), jax.tree_util.tree_leaves(jst)
    assert len(leaves) == len(jleaves)
    for leaf, jleaf in zip(leaves, jleaves):
        enc, jenc = cdc.encode_leaf(leaf), jcdc.encode_leaf(np.asarray(jleaf))
        assert _same_image(enc, jenc), (name, codec, jenc.dtype, jenc.shape)
        assert cdc.payload_nbytes(leaf) == jcdc.payload_nbytes(jleaf) \
            == enc.nbytes
        assert _bits(C.decode_leaf(enc)) == _bits(JC.decode_leaf(jenc))
    assert C.tree_nbytes(st, codec) == JC.tree_nbytes(jst, codec)
    # one wire crossing of the whole state: the reference's values, the
    # port's dtypes and devices
    back, jback = cdc.roundtrip(st), jcdc.roundtrip(jst)
    for b, leaf, jb in zip(pytree.leaves(back), leaves,
                           jax.tree_util.tree_leaves(jback)):
        assert b.dtype == leaf.dtype and b.device == leaf.device
        assert _bits(C.to_host(b)) == _bits(np.asarray(jb))


@pytest.mark.parametrize("codec", C.available_codecs())
def test_bfloat16_and_nonfinite_slices_match_reference(codec):
    """A bfloat16 leaf (raw under every codec) and float slices holding
    inf and NaN (a q8 slice's scale becomes inf or NaN): the reference's
    wire images bit for bit."""
    rng = np.random.default_rng(4)
    bf = torch.tensor(rng.normal(size=(3, 64)) * 40, dtype=torch.bfloat16)
    jbf = np.asarray(jnp.asarray(bf.float().numpy(), jnp.bfloat16))
    x = (rng.normal(size=(4, 3)) * 5).astype(np.float32)
    x[0, 1], x[2, 0], x[3, 2] = np.inf, np.nan, -np.inf
    cdc, jcdc = C.get_codec(codec), JC.get_codec(codec)
    assert _same_image(cdc.encode_leaf(bf), jcdc.encode_leaf(jbf))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # NaN -> int8 cast
        for leaf in (x, torch.from_numpy(x), x[0]):
            ref = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
            enc, jenc = cdc.encode_leaf(leaf), jcdc.encode_leaf(ref)
            assert _same_image(enc, jenc)
            assert _bits(C.decode_leaf(enc)) == _bits(JC.decode_leaf(jenc))


# ---------------------------------------------------------------------------
# roundtrip, fake_quant, accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", LOSSY)
def test_error_within_derived_bound(codec):
    cdc = C.get_codec(codec)
    rng = np.random.default_rng(3)
    arr = (rng.standard_t(3, size=(4, 5000)) * 100).astype(np.float32)
    dec = C.decode_leaf(cdc.encode_leaf(torch.from_numpy(arr)))
    atol = cdc.roundtrip_atol(arr) + 1e-7
    assert np.array_equal(atol, JC.get_codec(codec).roundtrip_atol(arr) + 1e-7)
    diff = np.abs(dec.astype(np.float64) - arr.astype(np.float64))
    assert np.all(diff.reshape(4, -1) <= atol)


def test_none_roundtrip_is_identity_object():
    tree = {"a": torch.arange(4.0), "s": torch.zeros(2, dtype=torch.int64)}
    assert C.get_codec("none").roundtrip(tree) is tree


def test_per_slice_scales_isolate_streams():
    arr = np.stack([np.linspace(-1e6, 1e6, 1 << 13),
                    np.linspace(-1.0, 1.0, 1 << 13)]).astype(np.float32)
    dec = C.decode_leaf(C.get_codec("q8").encode_leaf(torch.from_numpy(arr)))
    assert np.max(np.abs(dec[1] - arr[1])) <= 0.5 / 127 + 1e-7


def test_size_adaptive_switches_at_threshold():
    cdc = C.get_codec("size_adaptive")
    small = torch.ones(C.SIZE_ADAPTIVE_THRESHOLD - 1)
    big = torch.ones((2, C.SIZE_ADAPTIVE_THRESHOLD // 2))
    assert cdc.encode_leaf(small).kind == "fp16"
    assert cdc.encode_leaf(big).kind == "q8"


def test_fp16_clamps_instead_of_overflowing():
    arr = torch.tensor([1e9, -1e9, 3.0])
    dec = C.decode_leaf(C.get_codec("fp16").encode_leaf(arr))
    assert np.all(np.isfinite(dec))
    assert dec[0] == C.FP16_MAX and dec[1] == -C.FP16_MAX
    assert torch.equal(C.fake_quant(arr, "fp16"), torch.from_numpy(dec))


@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("shape", [(3, 1 << 12), (5000,), (2, 3, 40)])
def test_fake_quant_matches_host_grid_and_reference(codec, shape):
    """Bit for bit the reference's in-jit ``fake_quant``, and equal to the
    host decode(encode(x)) (``==``: a q grid's -0 decodes to +0 through
    int8), with exact .5 ties of the q grid included."""
    cdc = C.get_codec(codec)
    rng = np.random.default_rng(5)
    arr = (rng.normal(size=shape) * 50).astype(np.float32)
    flat = arr.reshape(-1)
    flat[:8] = np.float32(127.0) * np.float32(0.5) * np.arange(8)  # ties
    x = torch.from_numpy(arr)
    got = cdc.fake_quant(x)
    host = C.decode_leaf(cdc.encode_leaf(x))
    ref = np.asarray(jax.jit(JC.get_codec(codec).fake_quant)(jnp.asarray(arr)))
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _bits(got.numpy()) == _bits(ref)
    assert np.array_equal(got.numpy(), host)
    assert cdc.fake_quant(torch.arange(4)) is not None  # ints: passthrough
    seeds = torch.arange(6, dtype=torch.int64)
    assert cdc.fake_quant(seeds) is seeds


@pytest.mark.parametrize("codec", C.available_codecs())
def test_payload_nbytes_matches_encoding_and_reference(codec):
    cdc, jcdc = C.get_codec(codec), JC.get_codec(codec)
    for arr in (np.zeros((4, 1 << 12), np.float32),
                np.zeros(64, np.float32), np.arange(10, dtype=np.int32)):
        for leaf in (arr, torch.from_numpy(arr)):
            assert cdc.payload_nbytes(leaf) == cdc.encode_leaf(leaf).nbytes \
                == jcdc.payload_nbytes(arr)
    assert cdc.float_payload_nbytes(5000, 3) == \
        jcdc.float_payload_nbytes(5000, 3)


@pytest.mark.parametrize("codec", ["none", "fp16", "q8"])
def test_assert_trees_within_codec_as_reference(codec):
    """Passes where the reference's passes (a roundtripped state), fails
    where it fails (a float leaf pushed past the bound, a seed changed)."""
    jst = _jax_state("onepass")
    st = _port_state(jst, "onepass")
    back = C.get_codec(codec).roundtrip(st)
    C.assert_trees_within_codec(back, st, codec, label="port")
    JC.assert_trees_within_codec(JC.get_codec(codec).roundtrip(jst), jst,
                                 codec, label="jax")
    bad_table = st._replace(sketch=st.sketch._replace(
        table=st.sketch.table + 1e3))
    bad_seed = st._replace(seed_transform=st.seed_transform + 1)
    for bad in (bad_table, bad_seed):
        jbad = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jst), convert.state_to_numpy(bad))
        with pytest.raises(AssertionError) as got:
            C.assert_trees_within_codec(bad, st, codec, label="x")
        with pytest.raises(AssertionError) as want:
            JC.assert_trees_within_codec(jbad, jst, codec, label="x")
        assert str(got.value) == str(want.value)
