"""A frozen copy of the WORp hash family, in plain PyTorch.

The benchmark's reference computes every bucket, sign and ppswor variate
itself, from these constants, and imports nothing of the program.  uint32
values are held in int64 tensors in ``[0, 2**32)``; products are split into
16-bit halves so that no int64 product overflows, on the CPU or the card.

The system states its uniform variate as a float32 value: the top 24 bits
of a hash times 2**-24, plus 2**-25, each step rounded to float32.  Rounded
so, it is exactly 1.0 for one hash in 2**24, where ppswor's r = -log(u) is
0 and the transformed value infinite.  The reference keeps that edge, as the
stated semantics have it.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M1 = 0x7FEB352D
M2 = 0x846CA68B
ROW_SALT = 0x9E3779B9
SIGN_SALT = 0x85EBCA6B
EXP_SALT = 0xC2B2AE35
STREAM_T_SALT = 0xA5A5A5A5  # per-stream transform seeds: hash(b, seed ^ this)


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and c < 2**32."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, M1)
    x = x ^ (x >> 15)
    x = mul32(x, M2)
    return x ^ (x >> 16)


def u32(x) -> torch.Tensor:
    """int32 keys (two's complement) or any integers as uint32 in int64."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def hash_u32(keys: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Uniform uint32 of uint32 ``keys`` under ``salt`` (broadcast)."""
    return mix32(mix32((keys + salt) & MASK32) ^ mul32(salt, ROW_SALT))


def stream_seeds(num_streams: int, seed: int, device):
    """Per-stream (sketch, transform) seeds of independent streams drawn
    from one engine seed."""
    b = torch.arange(num_streams, dtype=torch.int64, device=device)
    s = torch.tensor(seed & MASK32, dtype=torch.int64, device=device)
    return hash_u32(b, s), hash_u32(b, s ^ STREAM_T_SALT)


def row_salt(seed: torch.Tensor, row: int) -> torch.Tensor:
    return (seed + mul32(torch.full_like(seed, row + 1), ROW_SALT)) & MASK32


def bucket_sign(keys: torch.Tensor, salt: torch.Tensor, width: int):
    """Bucket in [0, width) and sign +-1 (int64) of each key in one row."""
    bucket = hash_u32(keys, salt) % width
    sign = 1 - 2 * (hash_u32(keys, salt ^ SIGN_SALT) & 1)
    return bucket, sign


def uniform01(keys: torch.Tensor, tseed: torch.Tensor) -> torch.Tensor:
    """The stated float32 variate in (0, 1], returned as float64."""
    h = hash_u32(keys, tseed ^ EXP_SALT)
    exact = (h >> 8).to(torch.float64) * 2.0**-24 + 2.0**-25
    return exact.to(torch.float32).to(torch.float64)


def randomizer(keys, tseed, scheme: str) -> torch.Tensor:
    """r_x in float64: Exp[1] for ppswor, U(0, 1] for priority."""
    u = uniform01(keys, tseed)
    if scheme == "ppswor":
        return -torch.log(u)
    if scheme == "priority":
        return u
    raise ValueError(f"unknown bottom-k scheme {scheme!r}")


def _exponent(e: float, like: torch.Tensor) -> torch.Tensor:
    """An exponent rounded to float32 first, as the system states it, as a
    tensor: its power follows C99 at r = -0.0 (-inf for -1, +inf for -0.5
    and -2), where a Python float exponent may take another route."""
    return torch.tensor(e, dtype=torch.float32).to(torch.float64).to(
        like.device)


def transform_factor(keys, tseed, p: float, scheme: str) -> torch.Tensor:
    """r_x ** (-1/p) in float64 (Eq. 5's factor): infinite where the
    variate's r_x is -0.0."""
    r = randomizer(keys, tseed, scheme)
    return torch.pow(r, _exponent(-1.0 / p, r))


def inverse_factor(keys, tseed, p: float, scheme: str) -> torch.Tensor:
    """r_x ** (1/p) in float64 (Eq. 6's factor)."""
    r = randomizer(keys, tseed, scheme)
    return torch.pow(r, _exponent(1.0 / p, r))
