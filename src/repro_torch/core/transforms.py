"""The bottom-k (p-ppswor / p-priority) transform -- paper Eq. (4)-(6).

Sampling by nu^p with distribution D reduces to top-k by the *transformed*
frequency  nu*_x = nu_x / r_x^{1/p},  r_x ~ D.  Because r_x is a pure function
of (key, seed) the transform distributes over shards and signed updates.

D = Exp[1]   -> p-ppswor   (the paper's main instrument)
D = U[0, 1]  -> p-priority (sequential Poisson)

Seeds broadcast against keys: a batched caller passes ``seed[..., None]``.
"""
from __future__ import annotations

import torch

from . import hashing

PPSWOR = "ppswor"
PRIORITY = "priority"


def randomizer(keys, seed, scheme: str = PPSWOR) -> torch.Tensor:
    """r_x ~ D for each key, derived from the shared hash (Sec. 2.2)."""
    if scheme == PPSWOR:
        return hashing.exp1(keys, seed)
    if scheme == PRIORITY:
        return hashing.uniform01(keys, seed)
    raise ValueError(f"unknown bottom-k scheme: {scheme}")


def _pow32(r: torch.Tensor, exponent: float) -> torch.Tensor:
    """r ** exponent with the exponent rounded to float32 first, as the
    reference's ``jnp.asarray(exponent, float32)`` does.

    The power is taken in float64 and rounded back to r's type.  A float32
    ``torch.pow`` on the CPU runs a vectorized loop in the body of each
    intra-op thread's chunk and a scalar one in its tail, which differ by an
    ulp on ~2 % of inputs, so its bits would depend on the thread count; the
    float64 power rounded to float32 does not."""
    e = torch.tensor(exponent, dtype=torch.float32).to(torch.float64)
    # a tensor exponent: a Python -0.5 would take rsqrt, whose rsqrt(-0.0)
    # is -inf where pow(-0.0, -0.5) is +inf
    return torch.pow(r.to(torch.float64), e.to(r.device)).to(r.dtype)


def transform_values(keys, values: torch.Tensor, p: float, seed,
                     scheme: str = PPSWOR) -> torch.Tensor:
    """Element-wise transform (Eq. 5):  val -> val / r_key^{1/p}."""
    r = randomizer(keys, seed, scheme)
    return values * _pow32(r, -1.0 / p)


def transform_frequencies(keys, freqs: torch.Tensor, p: float, seed,
                          scheme: str = PPSWOR) -> torch.Tensor:
    """nu -> nu* on an aggregated vector (same math as transform_values)."""
    return transform_values(keys, freqs, p, seed, scheme)


def invert_frequency(keys, est_transformed: torch.Tensor, p: float, seed,
                     scheme: str = PPSWOR) -> torch.Tensor:
    """Eq. (6): recover nu'_x = nu*_x-hat * r_x^{1/p}."""
    r = randomizer(keys, seed, scheme)
    return est_transformed * _pow32(r, 1.0 / p)
