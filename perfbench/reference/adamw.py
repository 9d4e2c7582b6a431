"""AdamW with decoupled weight decay (Loshchilov and Hutter, "Decoupled
Weight Decay Regularization", 2019, Algorithm 2, with Adam's bias
corrections), one elementwise step in a dtype of the caller's choice."""
from __future__ import annotations

import torch


def step(p, g, m, v, t: int, lr: float, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.1,
         dtype=torch.float64):
    """(p, m, v) after step ``t`` (1 the first) from gradient ``g``, in
    ``dtype``, the parameter not rounded to its own type."""
    p, g = p.to(dtype), g.to(dtype)
    m = b1 * m.to(dtype) + (1 - b1) * g
    v = b2 * v.to(dtype) + (1 - b2) * g * g
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p), \
        m, v


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    a = x.abs().to(torch.float64).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)
