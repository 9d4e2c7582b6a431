"""Port parity: hashing, seeds and shard ids of ``repro_torch`` must equal
the JAX reference bit for bit (same numpy inputs into both packages)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import hashing as jh
from repro.engine import EngineConfig as JCfg
from repro.engine import derive_stream_seeds as j_derive
from repro_torch.core import hashing as th
from repro_torch.engine import EngineConfig as TCfg
from repro_torch.engine import derive_stream_seeds as t_derive
from tests._hypothesis_compat import given, settings, st

EDGE_KEYS = [0, -1, 1, 2**31 - 1, -2**31, 12345, -987654]
SALTS = [0, 1, 0x5EED, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]


def _keys(seed=0, n=512):
    rng = np.random.default_rng(seed)
    rand = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
    return np.concatenate([EDGE_KEYS, rand]).astype(np.int32)


def _jax_u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("salt", SALTS)
def test_hash_u32_bitwise(salt):
    k = _keys(salt % 97)
    want = _jax_u32(jh.hash_u32(jnp.asarray(k), jnp.uint32(salt)))
    got = th.hash_u32(torch.from_numpy(k), salt).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("salt", SALTS)
def test_uniform01_sign_bitwise(salt):
    k = _keys(salt % 89)
    tk = torch.from_numpy(k)
    assert np.array_equal(
        th.uniform01(tk, salt).numpy(),
        np.asarray(jh.uniform01(jnp.asarray(k), jnp.uint32(salt))))
    assert np.array_equal(
        th.sign_hash(tk, salt).numpy(),
        np.asarray(jh.sign_hash(jnp.asarray(k), jnp.uint32(salt))))


@pytest.mark.parametrize("width", [384, 1000, 2048])
@pytest.mark.parametrize("salt", [0, 2**31, 2**32 - 1])
def test_bucket_hash_bitwise(width, salt):
    k = _keys(width)
    want = np.asarray(jh.bucket_hash(jnp.asarray(k), jnp.uint32(salt), width))
    got = th.bucket_hash(torch.from_numpy(k), salt, width).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < width


@pytest.mark.parametrize("seed", [0, 7, 2**31, 2**32 - 1])
def test_row_salt_bitwise(seed):
    for row in range(8):
        want = int(jh.row_salt(jnp.uint32(seed), jnp.uint32(row)))
        assert int(th.row_salt(seed, row)) == want
    # batched: (B, 1) seeds against (rows,) rows broadcast
    seeds = torch.tensor([[seed], [3]], dtype=torch.int64)
    got = th.row_salt(seeds, torch.arange(6))
    assert int(got[0, 5]) == int(jh.row_salt(jnp.uint32(seed), jnp.uint32(5)))


def _ordinal(x):
    """float32 -> int64 in the order of the floats, -0 and +0 both 0 (as
    ``np.testing.assert_array_max_ulp`` counts)."""
    i = x.view(np.int32).astype(np.int64)
    return np.where(i < 0, -2**31 - i, i)


def test_exp1_within_ulps():
    """exp1 = -log(uniform01): the uniform is bitwise, the log may differ by
    a few ulps between PyTorch's and XLA's CPU implementations.  A failure
    names the key, salt, uniform and both logs of the worst element."""
    k = _keys(3, 4096)
    for salt in SALTS:
        want = np.asarray(jh.exp1(jnp.asarray(k), jnp.uint32(salt)))
        got = th.exp1(torch.from_numpy(k), salt).numpy()
        ulps = np.abs(_ordinal(got) - _ordinal(want))
        i = int(np.argmax(ulps))
        u = float(th.uniform01(torch.from_numpy(k[i:i + 1]), salt)[0])
        assert ulps[i] <= 4, (
            f"{ulps[i]} ulp at key {int(k[i])}, salt {salt:#x}: uniform01 "
            f"{u!r}, port {got[i]!r}, reference {want[i]!r}")


@pytest.mark.parametrize("n", [1, 7, 1000, 2**20, 2**31 - 1, 2**31 + 5,
                               2**32 - 1])
@pytest.mark.parametrize("salt", [0, 0x5A17AB1E, 2**32 - 1])
def test_key_hash_to_domain_bitwise(n, salt):
    """KeyHash (Eq. 13) into [n], int32 with the reference's wrap above
    2**31."""
    k = _keys(n % 97)
    want = np.asarray(jh.key_hash_to_domain(jnp.asarray(k), jnp.uint32(salt),
                                            n))
    got = th.key_hash_to_domain(torch.from_numpy(k), salt, n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("salt", [0, 0x5A17AB1E, 2**32 - 1])
def test_hash_u32_np_bitwise(salt):
    k = _keys(11)
    assert np.array_equal(th.hash_u32_np(k, salt), jh.hash_u32_np(k, salt))
    assert np.array_equal(th.hash_u32_np(k, salt).astype(np.int64),
                          th.hash_u32(torch.from_numpy(k), salt).numpy())


@pytest.mark.parametrize("num_shards", [1, 2, 3, 8, 13])
def test_shard_of_keys_bitwise(num_shards):
    k = np.abs(_keys(num_shards)).astype(np.int32)
    got = th.shard_of_keys(k, num_shards)
    assert got.dtype == np.int64
    assert np.array_equal(got, jh.shard_of_keys(k, num_shards))


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=-2**31, max_value=2**31 - 1),
       st.integers(min_value=0, max_value=2**32 - 1))
def test_hash_property_torch_equals_numpy_mirror(key, salt):
    ks = np.asarray([key, 0, -1, key ^ 0x5555], np.int64).astype(np.int32)
    assert np.array_equal(th.hash_u32(torch.from_numpy(ks), salt).numpy(),
                          th.hash_u32_np(ks, salt).astype(np.int64))


@pytest.mark.parametrize("seed,shared,offset", [
    (0x5EED, False, 0), (0x5EED, True, 0), (0x5EED, False, 12345),
    (2**31 + 17, False, 0), (2**32 - 1, False, 7), (2**31 + 17, True, 3),
])
def test_derive_stream_seeds_bitwise(seed, shared, offset):
    jcfg = JCfg(num_streams=6, seed=seed, shared_seeds=shared)
    tcfg = TCfg(num_streams=6, seed=seed, shared_seeds=shared)
    js, jt = j_derive(jcfg, offset=offset)
    ts, tt = t_derive(tcfg, offset=offset, device="cpu")
    assert np.array_equal(ts.numpy(), _jax_u32(js))
    assert np.array_equal(tt.numpy(), _jax_u32(jt))


def test_to_int32_wraps_explicitly():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    got = th.to_int32(x)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    assert th.as_u32(got).tolist() == x.tolist()


def test_seeds_concretely_differ():
    a = torch.tensor([1, 2, 3])
    assert not th.seeds_concretely_differ(a, np.array([1, 2, 3]))
    assert th.seeds_concretely_differ(a, torch.tensor([1, 2, 4]))
    assert th.seeds_concretely_differ(2**32 - 1, -2)
