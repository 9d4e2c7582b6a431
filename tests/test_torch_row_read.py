"""The row read's launch (kernels #2 ``countsketch_query_batched`` and #5
``countsketch_query``), on the CPU.

``csrc/countsketch_query.cu`` has two layouts (``tiling.row_read_launch``).
Where the reads fit one wave of the card's threads, a lane a read: block g
takes stream b's tile of 32 keys, warp r row r (rows past 32 loop), lane l
key 32 t + l, each read one hash chain and one load.  Past it, a lane a
key, its rows' reads issued four at a time.  A CUDA kernel has no CPU
mode, so here each layout's mapping is run in plain PyTorch over every
lane of its launch and held, bit for bit, to the Pallas kernel of the JAX
package (in interpret mode) and to the port's plain version, at the
shapes the card times it: B = 2, k = 512, rows 7 (``query_rows_batched``
in ``chip_smoke.py``), one table (#5), and 17 rows, where the estimate
falls back to the row read; each read is written exactly once.  The
product with +-1 is exact, so bit for bit is the tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.countsketch_query import countsketch_query_batched as jq
from repro_torch.core import hashing
from repro_torch.kernels import countsketch_query as tq
from repro_torch.kernels import ops, tiling


def _lane_model(tables, keys, seeds, blocks, threads, layout):
    """The row read's lanes over ``blocks`` blocks of ``threads`` in
    ``layout``: each lane's (stream, row, key) reads from its block, warp
    and lane, written to ``out[b, r, j]`` and counted per read."""
    B, rows, width = tables.shape
    k = keys.shape[1]
    if layout == tiling.ROW_READ_LANES:
        tiles = -(-k // 32)
        g = torch.arange(blocks)[:, None, None, None]
        warp = torch.arange(threads // 32)[None, :, None, None]
        lane = torch.arange(32)[None, None, :, None]
        loop = torch.arange(0, rows, threads // 32)[None, None, None, :]
        b = g // tiles
        j = (g - b * tiles) * 32 + lane
        r = warp + loop
        shape = (blocks, threads // 32, 32, loop.shape[-1])
    else:  # a lane a key, all its rows
        idx = torch.arange(blocks * threads)[:, None]
        b, j = idx // k, idx % k
        r = torch.arange(rows)[None, :]
        shape = (blocks * threads, rows)
    b, j, r = (x.expand(shape).reshape(-1) for x in (b, j, r))
    live = (j < k) & (r < rows) & (b < B)
    b, j, r = b[live], j[live], r[live]
    key = keys[b, j]
    salt = hashing.row_salt(hashing.as_u32(seeds)[b], r)
    bucket = hashing.bucket_hash(key, salt, width)
    out = torch.full((B, rows, k), float("nan"))
    out[b, r, j] = tables[b, r, bucket] * hashing.sign_hash(key, salt)
    count = torch.zeros((B, rows, k), dtype=torch.int64)
    count.index_put_((b, r, j), torch.ones_like(b), accumulate=True)
    return out, count


# (B, rows, width, k): chip_smoke.py's query_rows_batched (B = 2, k = 512,
# rows 7 x 2048), one table (#5), the 17-row fallback of the estimate, and
# a width that is not a power of two
SHAPES = [(2, 7, 2048, 512), (1, 7, 2048, 512), (3, 17, 256, 64),
          (2, 5, 1000, 37)]


@pytest.mark.parametrize("layout", ["lanes", "keys"])
@pytest.mark.parametrize("B,rows,width,k", SHAPES)
def test_row_read_lanes_equal_pallas_and_plain_bitwise(B, rows, width, k,
                                                       layout):
    """Every lane of the row read's launch, in each layout, run as plain
    PyTorch, gives the Pallas kernel's and the plain version's reads bit
    for bit, each read written once."""
    rng = np.random.default_rng(B * 1000 + rows + k)
    tables = rng.normal(size=(B, rows, width)).astype(np.float32)
    keys = rng.integers(-2**31, 2**31 - 1, (B, k)).astype(np.int32)
    keys[:, 0] = -1
    seeds = np.array([0, 2**31 + 7, 2**32 - 1], np.uint32)[:B]
    # the card's launch of this shape, or (no SM: every read past one
    # wave) its layout past one wave
    sms = 132 if layout == "lanes" else 0
    blocks, threads, got_layout = tiling.row_read_launch(B, rows, k, sms)
    assert got_layout == (tiling.ROW_READ_LANES if layout == "lanes"
                          else tiling.ROW_READ_KEYS)
    got, count = _lane_model(torch.from_numpy(tables),
                             torch.from_numpy(keys).to(torch.int64),
                             torch.from_numpy(seeds.astype(np.int64)),
                             blocks, threads, got_layout)
    assert bool((count == 1).all())
    pallas = np.asarray(jq(jnp.asarray(tables), jnp.asarray(keys),
                           jnp.asarray(seeds), interpret=True))
    oracle = np.asarray(jref.countsketch_query_batched_ref(
        jnp.asarray(tables), jnp.asarray(keys), jnp.asarray(seeds)))
    plain = ops.query_rows_batched(torch.from_numpy(tables),
                                   torch.from_numpy(keys),
                                   torch.from_numpy(seeds.astype(np.int64)))
    for want in (pallas, oracle, plain.numpy()):
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(want).view(np.int32))


def test_row_read_launch_is_sized_from_its_reads():
    """A lane a read within one wave of the card's threads (132 SMs x
    2048): 32 blocks of 7 warps at B = 2, k = 512, rows 7 (the design this
    replaced: 4 blocks of a thread a key, its rows in turn); rows past 32
    loop over 32 warps.  Past one wave, as at the flush's B = 4096 x 512
    keys, a lane a key: 8,192 blocks of 256."""
    launch, lanes, keys = (tiling.row_read_launch, tiling.ROW_READ_LANES,
                           tiling.ROW_READ_KEYS)
    assert launch(2, 7, 512, 132) == (32, 224, lanes)
    assert launch(1, 7, 512, 132) == (16, 224, lanes)
    assert launch(3, 40, 5, 132) == (3, 1024, lanes)
    assert launch(4096, 7, 512, 132) == (8192, 256, keys)
    assert launch(4096, 17, 512, 132) == (8192, 256, keys)
    assert launch(75, 7, 512, 132)[2] == lanes
    assert launch(76, 7, 512, 132)[2] == keys


def test_split_and_row_read_entries_pass_pointers_as_void_p():
    """The C entries' ctypes signatures: pointers as ``c_void_p`` (a
    pointer passed as a 32-bit int would be cut); the row read takes its
    layout and the det scatter its split (``row_group``, ``ranges``,
    ``blocks``) as ints."""
    import ctypes

    from repro_torch.kernels import countsketch_scatter as ts

    assert tq._QUERY_ARGTYPES[:4] == [ctypes.c_void_p] * 4
    assert tq._QUERY_ARGTYPES[4:-1] == [ctypes.c_int] * 7
    assert tq._QUERY_ARGTYPES[-1] is ctypes.c_void_p
    assert ts._DET_ARGTYPES[:6] == [ctypes.c_void_p] * 6
    assert ts._DET_ARGTYPES[12:18] == [ctypes.c_int] * 6
    assert ts._DET_ARGTYPES[-1] is ctypes.c_void_p and len(
        ts._DET_ARGTYPES) == 19
