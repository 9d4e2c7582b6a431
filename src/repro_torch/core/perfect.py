"""Perfect (oracle) samplers over aggregated frequency vectors.

Ground truth for tests and benchmarks (paper Sec. 7 compares WORp against
'perfect WOR' = p-ppswor and 'perfect WR').  They read the explicit
frequency vector, which WORp exists to avoid: oracles, not sketches.
Vectors may carry leading batch axes, ``(..., n)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hashing, transforms


class Sample(NamedTuple):
    keys: torch.Tensor       # (..., k) int32 sampled keys, by decreasing |nu*|
    freqs: torch.Tensor      # (..., k) frequencies nu_x (exact or estimated)
    threshold: torch.Tensor  # (...) tau = (k+1)-st largest |nu*|
    transformed: torch.Tensor  # (..., k) nu*_x of the sampled keys


def ppswor_sample(freqs: torch.Tensor, k: int, p: float, seed,
                  scheme: str = transforms.PPSWOR) -> Sample:
    """Exact bottom-k (p-ppswor / p-priority) sample of nu^p: the top-k
    keys by |nu*_x| = |nu_x| / r_x^{1/p}, ties to the lowest key, threshold
    = the (k+1)-st magnitude.  ``seed`` is a uint32 value per stream."""
    from .worp import top_k

    keys = torch.arange(freqs.shape[-1], dtype=torch.int32,
                        device=freqs.device)
    seed = hashing.as_u32(seed, device=freqs.device)[..., None]
    tstar = transforms.transform_frequencies(keys, freqs.to(torch.float32),
                                             p, seed, scheme)
    top_vals, top_idx = top_k(torch.abs(tstar), k + 1)
    sel = top_idx[..., :k]
    return Sample(keys=sel.to(torch.int32),
                  freqs=torch.gather(freqs, -1, sel),
                  threshold=top_vals[..., k],
                  transformed=torch.gather(tstar, -1, sel))


def wr_sample(freqs: torch.Tensor, k: int, p: float,
              generator: torch.Generator) -> torch.Tensor:
    """Perfect WITH-replacement ell_p sample: k i.i.d. draws with
    probability |nu_x|^p / ||nu||_p^p, from ``generator``.  (The reference
    draws from a JAX PRNG key; the two agree in distribution only.)"""
    f = torch.abs(freqs.to(torch.float32))
    logits = p * torch.log(torch.clamp(f, min=1e-38))
    logits = torch.where(freqs == 0, float("-inf"), logits)
    probs = torch.softmax(logits, -1)
    return torch.multinomial(probs, k, replacement=True,
                             generator=generator).to(torch.int32)


def successive_wor_probability(freqs: torch.Tensor, sample_keys: torch.Tensor,
                               p: float) -> torch.Tensor:
    """prod_j  w_{i_j} / (||w||_1 - sum_{h<j} w_{i_h})  with w = |nu|^p, in
    float64 (Appendix F: the k-tuple probability of successive WOR
    sampling)."""
    w = torch.abs(freqs.to(torch.float64)) ** p
    total = w.sum(-1, keepdim=True)
    picked = torch.gather(w, -1, sample_keys.to(torch.int64))
    cum = torch.cat([torch.zeros_like(picked[..., :1]),
                     torch.cumsum(picked, -1)[..., :-1]], -1)
    return torch.prod(picked / (total - cum), -1)
