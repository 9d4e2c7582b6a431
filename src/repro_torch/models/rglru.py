"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
(plain PyTorch).

The port's counterpart of ``repro.models.rglru``.  Recurrence:
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
  r_t = sigmoid(W_a x_t + b_a)   (recurrence gate)
  i_t = sigmoid(W_x x_t + b_x)   (input gate)
with diagonal (per-channel) gate linears, in float32.  Train and prefill
run a log-depth parallel scan over the sequence (Hillis-Steele: log2(S)
rounds of tensor operations, where the reference's
``jax.lax.associative_scan`` runs an odd-even recursion, so the two agree
to rounding, not bit for bit); decode is the O(1) step.  The block wraps
the recurrence with in-proj branches, a width-4 causal conv and a GeLU
output gate (``jax.nn.gelu``'s tanh form).  The softplus is
``F.softplus`` (see ``models/ssm.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard

_C = 8.0


def _gates(x, lp):
    """x (B,S,W) -> (a, gated input) with diagonal gate linears."""
    f32 = torch.float32
    x32 = x.to(f32)
    r = torch.sigmoid(x32 * lp["w_a"].to(f32) + lp["b_a"].to(f32))
    i = torch.sigmoid(x32 * lp["w_x"].to(f32) + lp["b_x"].to(f32))
    log_a = -_C * F.softplus(lp["lam"].to(f32)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * x32


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = 0):
    Hillis-Steele, each round combining every position with the one d
    before it, (a1, b1) then (a2, b2) -> (a1 a2, b1 a2 + b2)."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_scan(x, lp, h0=None):
    """Parallel linear-recurrence scan.  x (B,S,W) -> (y, h_final)."""
    a, b = _gates(x, lp)
    if h0 is not None:
        # fold the carried state in as an extra leading step
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.to(torch.float32)[:, None], b], dim=1)
    hh = _linear_scan(a, b)
    if h0 is not None:
        hh = hh[:, 1:]
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(x, lp, h):
    """One decode step.  x (B,1,W), h (B,W)."""
    a, b = _gates(x, lp)
    h_new = a[:, 0] * h.to(torch.float32) + b[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def _causal_conv(x, conv_w, conv_state=None):
    """Depthwise causal conv1d (K, W).  Returns (y, new_state (B,K-1,W))."""
    K = conv_w.shape[0]
    if conv_state is None:
        pad = x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:])
    else:
        pad = conv_state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * conv_w[i] for i in range(K))
    return y, xp[:, -(K - 1):]


def recurrent_block(x, lp, mode: str, state=None):
    """Griffin recurrent block.  x (B,S,D) -> (y, new_state).

    lp: in_x (D,W), in_g (D,W), conv (K,W), w_a/b_a/w_x/b_x/lam (W,),
        out (W,D).
    state: dict(conv (B,K-1,W), h (B,W)) for decode / chunked prefill.
    """
    xb = torch.einsum("bsd,dw->bsw", x, lp["in_x"])
    gb = F.gelu(torch.einsum("bsd,dw->bsw", x, lp["in_g"]),
                approximate="tanh")
    xb = shard(xb, "act_batch", "act_seq", "act_lru")

    conv_state = state["conv"] if state is not None else None
    xb, new_conv = _causal_conv(xb, lp["conv"], conv_state)

    if mode == "decode":
        y, h_new = rglru_step(xb, lp, state["h"])
    else:
        h0 = state["h"] if state is not None else None
        y, h_new = rglru_scan(xb, lp, h0)

    out = torch.einsum("bsw,wd->bsd", y * gb, lp["out"])
    return out, {"conv": new_conv, "h": h_new}
