"""Stateless, seed-keyed hashing primitives for WORp sketches (PyTorch).

Every function is a pure function of (key, salt): the same key maps to the
same random variate on every host, shard and pass, and bit for bit to what
``repro.core.hashing`` gives.  That agreement is what lets sketches built by
either package (or by the CUDA kernels, which carry the same mixer in
``kernels/csrc/hashing.cuh``) merge.

Representation: uint32 values are held in ``torch.int64`` tensors in
``[0, 2**32)``.  PyTorch's ``uint32`` has no ``>>`` or ``%`` on the CPU, so
the mixer runs in int64, masked to 32 bits after every step.  Products are
split into 16-bit halves so that no int64 product overflows; the same code
therefore runs on CPU and CUDA tensors alike.
"""
from __future__ import annotations

import numpy as _np
import torch

MASK32 = 0xFFFFFFFF

# Murmur3/lowbias32-style finalizer constants (same values as the reference).
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_ROW_SALT = 0x9E3779B9  # golden-ratio increment per sketch row
_SIGN_SALT = 0x85EBCA6B
_EXP_SALT = 0xC2B2AE35
_SHARD_SALT = 0x5A17AB1E  # dedicated stream-partition salt


def as_u32(x, device=None) -> torch.Tensor:
    """uint32 value(s) as an int64 tensor in ``[0, 2**32)``.

    Negative int32 keys wrap to their two's-complement uint32 value, as
    ``jnp.asarray(keys, jnp.uint32)`` does."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device if device is not None else x.device,
                 dtype=torch.int64)
    else:
        t = torch.as_tensor(_np.asarray(x, _np.int64), dtype=torch.int64,
                            device=device)
    return t & MASK32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with explicit two's-complement
    wrap (the form a kernel argument takes)."""
    x = x.to(torch.int64)
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def int32_arg(x, n: int, device) -> torch.Tensor:
    """A kernel's (n,) int32 argument of uint32 values (``to_int32``'s
    wrap), broadcast from a scalar, array or tensor.  A scalar is filled on
    the device, so no blocking host-to-device copy precedes the launch."""
    if isinstance(x, torch.Tensor):
        return to_int32(as_u32(x, device=device).expand(n)).contiguous()
    a = _np.asarray(x, _np.int64) & MASK32
    a = (a + 2**31) % 2**32 - 2**31
    if a.ndim == 0:
        return torch.full((n,), int(a), dtype=torch.int32, device=device)
    return torch.from_numpy(a.astype(_np.int32)).to(device).expand(
        n).contiguous()


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and c a uint32 constant or
    tensor, without any int64 product overflowing: x is split into 16-bit
    halves, so each partial product stays below 2**48."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Low-bias 32-bit integer finalizer (avalanching mixer)."""
    x = x ^ (x >> 16)
    x = mul32(x, _M1)
    x = x ^ (x >> 15)
    x = mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash_u32(keys, salt) -> torch.Tensor:
    """Hash integer keys to uniform uint32 (int64 in [0, 2**32)), keyed by
    ``salt``; ``salt`` broadcasts against ``keys``."""
    k = as_u32(keys)
    s = as_u32(salt, device=k.device)
    return _mix32(_mix32((k + s) & MASK32) ^ mul32(s, _ROW_SALT))


def uniform01(keys, salt) -> torch.Tensor:
    """Uniform(0, 1] float32 from a hash (top 24 bits, plus 2**-25)."""
    h = hash_u32(keys, as_u32(salt) ^ _EXP_SALT)
    u = (h >> 8).to(torch.float32) * 2.0**-24
    return u + 2.0**-25


def exp1(keys, salt) -> torch.Tensor:
    """Per-key Exp[1] variate r_x (the ppswor randomization, Sec. 2.1)."""
    return -torch.log(uniform01(keys, salt))


def sign_hash(keys, salt) -> torch.Tensor:
    """Rademacher +-1 (float32), keyed by ``salt`` (CountSketch sign hash)."""
    h = hash_u32(keys, as_u32(salt) ^ _SIGN_SALT)
    return 1.0 - 2.0 * (h & 1).to(torch.float32)


def bucket_hash(keys, salt, width: int) -> torch.Tensor:
    """Bucket id in [0, width) as int64 (CountSketch bucket hash)."""
    return hash_u32(keys, salt) % int(width)


def key_hash_to_domain(keys, salt, n: int) -> torch.Tensor:
    """KeyHash: map integer-encoded keys into [n] (paper Eq. 13), as int32
    with two's-complement wrap for n > 2**31, as the reference's
    ``astype(int32)``."""
    return to_int32(hash_u32(keys, salt) % int(n))


def row_salt(seed, row) -> torch.Tensor:
    """Per-row salt for multi-row sketches: decorrelated via golden-ratio
    step; ``seed`` and ``row`` broadcast."""
    seed = as_u32(seed)
    row = as_u32(row, device=seed.device)
    return (seed + mul32((row + 1) & MASK32, _ROW_SALT)) & MASK32


# ---------------------------------------------------------------------------
# host-side numpy mirrors (stream partitioning decisions)
# ---------------------------------------------------------------------------

def _mix32_np(x: _np.ndarray) -> _np.ndarray:
    """Numpy mirror of ``_mix32`` (bit-identical on uint32)."""
    x = _np.asarray(x, _np.uint32)
    x = x ^ (x >> _np.uint32(16))
    x = (x * _np.uint32(_M1)).astype(_np.uint32)
    x = x ^ (x >> _np.uint32(15))
    x = (x * _np.uint32(_M2)).astype(_np.uint32)
    x = x ^ (x >> _np.uint32(16))
    return x


def hash_u32_np(keys, salt) -> _np.ndarray:
    """Numpy mirror of ``hash_u32``, returning uint32."""
    with _np.errstate(over="ignore"):
        k = _np.asarray(keys).astype(_np.uint32)
        s = _np.uint32(salt)
        return _mix32_np(_mix32_np((k + s).astype(_np.uint32))
                         ^ _np.uint32(s * _np.uint32(_ROW_SALT)))


def shard_of_keys(keys, num_shards: int) -> _np.ndarray:
    """Per-key shard id in ``[0, num_shards)`` (int64) for partitioning a
    stream by key: a key's insertions and its later deletions always land on
    the same shard."""
    if num_shards <= 1:
        return _np.zeros(_np.shape(keys), _np.int64)
    h = hash_u32_np(keys, _SHARD_SALT)
    return (h % _np.uint32(num_shards)).astype(_np.int64)


def seeds_concretely_differ(a, b) -> bool:
    """True when two seed arrays differ (the mergeability check's
    primitive).  PyTorch runs eagerly, so seeds are always concrete."""
    a = as_u32(a)
    return bool(torch.any(a != as_u32(b, device=a.device)))
