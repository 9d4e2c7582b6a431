"""Traffic generators: every input of a run drawn on the run's device from
``--seed``, in a few large calls.

``zipf_turnstile_pool`` draws the turnstile Zipf stream of the paper's
experiments (and of the program's ``data.pipeline.TurnstileZipfStream``):
ranks Zipf(alpha) clipped to ``vocab - 1`` by inversion of the exact
clipped distribution, each batch inserting fresh draws and retracting the
leading share of the previous batch's inserts.  ``gradient_pool`` draws
gradient-like values: a fixed per-coordinate scale exp(log_scale * g) of
each leaf times fresh N(0, 1) noise each step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed and a stream
    number, so that each pool has draws of its own for every seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def zipf_cdf(alpha: float, vocab: int) -> torch.Tensor:
    """P(key <= i) for i < vocab - 1 of ranks Zipf(alpha) on 1, 2, ...
    mapped to key = min(rank - 1, vocab - 1) (float64, on the CPU)."""
    ranks = torch.arange(1, vocab, dtype=torch.float64)
    zeta = torch.special.zeta(torch.tensor(alpha, dtype=torch.float64),
                              torch.tensor(1.0, dtype=torch.float64))
    return torch.cumsum(ranks ** -alpha, 0) / zeta


def zipf_keys(shape, alpha: float, vocab: int, gen: torch.Generator,
              cdf: torch.Tensor | None = None) -> torch.Tensor:
    """int32 keys of the clipped Zipf(alpha) law, by inversion."""
    dev = gen.device
    cdf = (zipf_cdf(alpha, vocab) if cdf is None else cdf).to(dev)
    u = torch.rand(shape, dtype=torch.float64, device=dev, generator=gen)
    return torch.searchsorted(cdf, u, right=True).to(torch.int32)


class TurnstilePool(NamedTuple):
    keys: torch.Tensor     # (P, B, inserts + retracts) int32
    values: torch.Tensor   # (P, B, inserts + retracts) float32, +1 / -1
    prime_keys: torch.Tensor    # (B, inserts + retracts): batch P-1's
    prime_values: torch.Tensor  # inserts alone, the rest padding (-1, 0)


def zipf_turnstile_pool(streams: int, inserts: int, retract_share: float,
                        alpha: float, vocab: int, pool: int, seed: int,
                        device) -> TurnstilePool:
    """``pool`` distinct (B, n) batches, n = inserts + retracts: batch j
    inserts its own draws (+1) and retracts the first ``retracts`` inserts
    of batch j - 1 (cyclically, -1).  The priming batch inserts batch
    P - 1's draws alone, so that replayed in order from it every retraction
    follows its insertion."""
    retracts = int(inserts * retract_share)
    gen = generator(seed, device, 1)
    cdf = zipf_cdf(alpha, vocab).to(device)
    ins = torch.stack([zipf_keys((streams, inserts), alpha, vocab, gen, cdf)
                       for _ in range(pool)])
    prev = torch.roll(ins, 1, 0)[:, :, :retracts]
    keys = torch.cat([ins, prev], 2).contiguous()
    values = torch.cat([
        torch.ones((pool, streams, inserts), dtype=torch.float32,
                   device=device),
        -torch.ones((pool, streams, retracts), dtype=torch.float32,
                    device=device)], 2).contiguous()
    pad = torch.full((streams, retracts), -1, dtype=torch.int32,
                     device=device)
    prime_keys = torch.cat([ins[-1], pad], 1).contiguous()
    prime_values = torch.where(prime_keys == -1, 0.0, 1.0).to(torch.float32)
    return TurnstilePool(keys, values, prime_keys, prime_values)


def gradient_pool(sizes, log_scale: float, pool: int, seed: int,
                  device) -> torch.Tensor:
    """(P, L, n_max) float32 gradient steps of L leaves, zero past each
    leaf's length: leaf b's coordinates carry a fixed scale
    exp(log_scale * g), g ~ N(0, 1), times fresh N(0, 1) noise each step."""
    n_max = max(sizes)
    out = torch.zeros((pool, len(sizes), n_max), dtype=torch.float32,
                      device=device)
    gen = generator(seed, device, 2)
    for b, n in enumerate(sizes):
        scale = torch.randn(n, device=device, generator=gen)
        scale.mul_(log_scale).exp_()
        noise = out[:, b, :n]
        noise.normal_(generator=gen)
        noise.mul_(scale)
    return out
