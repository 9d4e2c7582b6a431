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
choices and all its choices as device tensors (no host sync);
``count_routes()`` each call's routed choices a held expert.  Neither
counts a layer's forward run again in backward (recomputation).

``moe_held`` is the expert layer of expert parallelism, dropless: told
which experts it holds (an offset and a count of the ``E`` the router
scores), it routes every token over all ``E``, sorts the choices that fall
to its own experts by expert, runs each held expert on its tokens (grouped
products over the sorted choices, their group ends on the device), and
returns its experts' part of the layer's output; choices to absent experts
contribute nothing here (they are other chips' part).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import worp
from repro_torch.distributed.sharding import shard

from repro_torch.trace import span

from .layers import recomputing, silu

_DROPS: list | None = None  # (dropped, choices) per call inside count_drops
_ROUTES: list | None = None  # (held,) routed choices per call


@contextlib.contextmanager
def count_routes():
    """Yield a list that gathers, one a ``moe_held`` call until the block
    ends, the (held,) int64 device tensor of routed choices each held
    expert received."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


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
    if _DROPS is not None and not recomputing():
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


def moe_held(x: torch.Tensor, mp: dict, top_k: int, offset: int,
             held: int) -> torch.Tensor:
    """x (B, S, D) -> the held experts' part of a dropless top-k MoE.

    mp: router (D, E) over all E experts; wg, wi (held, D, F), wo (held,
    F, D) of experts [offset, offset + held).  The router is float32;
    each token's top-k logits (``worp.top_k``'s order) are softmaxed into
    its gates, and a held expert's output is weighted by its gate.  The
    T * K choices are sorted by held expert (the others last) and the
    experts' products run as grouped products over that order, their
    group ends on the device: no read back to the host, and no atomics
    (the rows move by the sort's order, each choice to its own place).  A
    token picks an expert once, so T * min(K, held) rows hold every held
    choice; the grouped products compute only the held ones."""
    B, S, D = x.shape
    T, K = B * S, top_k
    xt = x.reshape(T, D)
    with span("moe.route"):
        logits = xt.to(torch.float32) @ mp["router"].to(torch.float32)
        top_logits, top_idx = worp.top_k(logits, K)           # (T, K)
        gates = torch.softmax(top_logits, dim=-1)
        local = (top_idx - offset).reshape(-1)
        key = torch.where((local >= 0) & (local < held), local, held)
        # a token picks an expert once: at most T * min(K, held) are held
        order = torch.argsort(key, stable=True)[:T * min(K, held)]
        counts = torch.zeros(held + 1, dtype=torch.int64,
                             device=x.device).scatter_add_(
            0, key, torch.ones_like(key))[:held]
        if _ROUTES is not None and not recomputing():
            _ROUTES.append(counts)
        ends = torch.cumsum(counts, 0)
        if _DROPS is not None and not recomputing():
            # held choices past the rows kept: none while a token picks
            # an expert once
            _DROPS.append(((ends[-1] - order.numel()).clamp_min(0), T * K))
        live = (torch.arange(order.numel(), device=x.device)
                < ends[-1])[:, None]
        gate = gates.reshape(-1)[order][:, None]
        # rows past the held choices are left unwritten by the grouped
        # products (forward and backward): masked where they enter and
        # leave, never scaled
        xs = torch.where(live, _Dispatch.apply(xt, order, K), 0.0)
    with span("moe.experts"):
        y = torch.where(live, _experts(xs, mp, ends), 0.0)
        return _Combine.apply(y * gate.to(y.dtype), order, T, K).reshape(
            B, S, D)


def _per_choice(rows, order, T: int, K: int):
    """(T, K, D): each sorted row at its choice's place (``order`` holds
    distinct choices), zero where no row is."""
    out = rows.new_zeros((T * K, rows.shape[-1]))
    return out.index_copy_(0, order, rows).reshape(T, K, -1)


class _Dispatch(torch.autograd.Function):
    """Row r of the output is token order[r] // K's row of ``xt``; the
    backward puts each row's gradient at its choice's place and sums a
    token's K choices (no atomics)."""

    @staticmethod
    def forward(ctx, xt, order, K):
        ctx.save_for_backward(order)
        ctx.T, ctx.K = xt.shape[0], K
        return xt[torch.div(order, K, rounding_mode="floor")]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        return _per_choice(g, order, ctx.T, ctx.K).sum(1), None, None


class _Combine(torch.autograd.Function):
    """The sum of each token's K choices' rows (``y`` in the sorted order
    ``order``); the backward hands each sorted row its token's
    gradient."""

    @staticmethod
    def forward(ctx, y, order, T, K):
        ctx.save_for_backward(order)
        ctx.K = K
        return _per_choice(y, order, T, K).sum(1)

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        return g[torch.div(order, ctx.K, rounding_mode="floor")], None, \
            None, None


def _experts(xs, mp: dict, ends):
    """Each held expert's SwiGLU on its rows of ``xs`` (rows
    [ends[e - 1], ends[e]) to expert e, a device tensor): three grouped
    products (``torch._grouped_mm``)."""
    offs = ends.to(torch.int32)
    a = silu(torch._grouped_mm(xs, mp["wg"], offs=offs)) \
        * torch._grouped_mm(xs, mp["wi"], offs=offs)
    return torch._grouped_mm(a, mp["wo"], offs=offs)


def aux_load_balance_loss(x, router, num_experts: int, top_k: int):
    """Switch-style load-balance auxiliary loss (fraction x prob an
    expert)."""
    probs, _, idx = _route(x, router, top_k)
    frac = torch.mean(torch.nn.functional.one_hot(idx, num_experts).to(
        torch.float32), dim=(0, 1, 2))
    pmean = torch.mean(probs, dim=(0, 1))
    return num_experts * torch.sum(frac * pmean)
