"""Token-choice top-k MoE, capacity-bounded (plain PyTorch).

The port's counterpart of ``repro.models.moe``, with its dataflow: the
router in float32, top-k by ``worp.top_k`` (``lax.top_k``'s tie order:
the lower expert index first), the position of each (token, choice) in its
expert a cumsum per batch row over the flattened ``(S*K)`` choices,
token-major, a ``(B, E*cap + 1, D)`` dispatch buffer, the experts' SwiGLU
einsums batched over E, and the gather back.  A choice at ``pos >= cap``
is dropped: its slot is ``E*cap`` and its gate zero.  Every choice is
written into the buffer, the dropped ones all into the dump slot ``E*cap``,
which is sliced off before the experts: the dispatch is shape-static (it
runs on ``device="meta"``, for the dry-run's counts), and the kept slots
never repeat, so the result does not depend on which duplicate write to
the dump slot wins on the card.

``count_drops()`` collects, while it is entered, each call's dropped
choices and all its choices as device tensors (no host sync).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import worp
from repro_torch.distributed.sharding import shard

from .layers import silu

_DROPS: list | None = None  # (dropped, choices) per call inside count_drops


@contextlib.contextmanager
def count_drops():
    """Yield a list that gathers ``(dropped, choices)`` device tensors, one
    pair a ``moe_ffn`` call, until the block ends."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


def _route(x, router, k: int):
    """Softmax router in float32: (probs, gate values, expert ids)."""
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = worp.top_k(probs, k)  # (B,S,K)
    return probs, gate_vals, expert_idx


def moe_ffn(x: torch.Tensor, mp: dict, num_experts: int, top_k: int,
            capacity_factor: float) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) through top-k of E experts (SwiGLU experts).

    mp: router (D, E), wg (E, D, F), wi (E, D, F), wo (E, F, D).
    """
    B, S, D = x.shape
    E, K = num_experts, top_k
    cap = int((S * K / E) * capacity_factor + 1)

    _, gate_vals, expert_idx = _route(x, mp["router"], K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # --- per-row dispatch: position of each (token, choice) in its expert ---
    e_flat = expert_idx.reshape(B, S * K)
    oh = torch.nn.functional.one_hot(e_flat, E).to(torch.int32)  # (B,S*K,E)
    pos_in_e = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1
    pos = torch.sum(pos_in_e * oh, dim=-1)                     # (B, S*K)
    ok = pos < cap
    slot = torch.where(ok, e_flat * cap + pos, E * cap)  # overflow -> dropped
    if _DROPS is not None:
        _DROPS.append(((~ok).sum(), ok.numel()))

    x_rep = torch.repeat_interleave(x, K, dim=1)  # (B, S*K, D)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = x.new_zeros((B, E * cap + 1, D))
    buf = buf.index_put((rows, slot), x_rep)
    h = buf[:, : E * cap].reshape(B, E, cap, D)
    h = shard(h, "act_batch", "act_experts", None, None)

    # --- expert SwiGLU (batched over E) ---
    a = silu(torch.einsum("becd,edf->becf", h, mp["wg"])) * torch.einsum(
        "becd,edf->becf", h, mp["wi"])
    a = shard(a, "act_batch", "act_experts", None, "act_mlp")
    y = torch.einsum("becf,efd->becd", a, mp["wo"])  # (B,E,cap,D)

    # --- combine back ---
    y_flat = torch.cat([y.reshape(B, E * cap, D), y.new_zeros((B, 1, D))],
                       dim=1)
    y_rep = y_flat[rows, slot]  # (B, S*K, D)
    y_tok = (y_rep.reshape(B, S, K, D)
             * gate_vals[..., None].to(y_rep.dtype)
             * ok.reshape(B, S, K, 1).to(y_rep.dtype))
    return y_tok.sum(dim=2)


def aux_load_balance_loss(x, router, num_experts: int, top_k: int):
    """Switch-style load-balance auxiliary loss (fraction x prob an
    expert)."""
    probs, _, idx = _route(x, router, top_k)
    frac = torch.mean(torch.nn.functional.one_hot(idx, num_experts).to(
        torch.float32), dim=(0, 1, 2))
    pmean = torch.mean(probs, dim=(0, 1))
    return num_experts * torch.sum(frac * pmean)
