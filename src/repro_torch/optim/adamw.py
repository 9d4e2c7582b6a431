"""AdamW (decoupled weight decay) on tensor trees (PyTorch port of
``repro.optim.adamw``).

The optimizer state mirrors the parameter tree; first and second moments
are float32 whatever the parameters' dtype.  Trees are walked in the
reference's leaf order (``repro_torch.distributed.pytree``).
``abstract_state`` is the dry-run's mirror on ``device="meta"``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed import pytree


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: Any             # first moments (float32 tree)
    nu: Any             # second moments (float32 tree)


def init(params) -> AdamWState:
    """Zero moments shaped as each parameter, on its device; step 0 on the
    first parameter's device."""
    leaves = pytree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=pytree.tree_map(f32, params),
        nu=pytree.tree_map(f32, params),
    )


def abstract_state(abstract_params) -> AdamWState:
    """Meta-tensor mirror for the dry-run: float32 moments of each
    (per-card) parameter's shape, an int32 scalar step."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=pytree.tree_map(f32, abstract_params),
        nu=pytree.tree_map(f32, abstract_params),
    )


def _step(p, g, m, v, bc1, bc2, lr, b1, b2, eps, weight_decay):
    """One leaf's AdamW: (new parameter in its dtype, new float32 moments),
    ``bc1``/``bc2`` the float32 bias corrections."""
    g32 = g.to(torch.float32)
    m_new = b1 * m + (1.0 - b1) * g32
    v_new = b2 * v + (1.0 - b2) * g32 * g32
    p32 = p.to(torch.float32)
    delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) \
        + weight_decay * p32
    return (p32 - lr * delta).to(p.dtype), m_new, v_new


def update(
    params,
    grads,
    state: AdamWState,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One AdamW step.  Returns (new_params, new_state).

    As the reference: the bias corrections are float32 powers of the step,
    and every scalar enters the float32 arithmetic as a float32."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

    flat_p = pytree.leaves(params)
    flat_g = pytree.leaves(grads)
    flat_m = pytree.leaves(state.mu)
    flat_v = pytree.leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(
            f"adamw.update: params, grads and moments must have the same "
            f"leaves, got {len(flat_p)}, {len(flat_g)}, {len(flat_m)}, "
            f"{len(flat_v)}")
    outs = [_step(p, g, m, v, bc1.to(m.device), bc2.to(v.device), lr, b1,
                  b2, eps, weight_decay)
            for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = pytree.unflatten(params, [o[0] for o in outs])
    new_m = pytree.unflatten(params, [o[1] for o in outs])
    new_v = pytree.unflatten(params, [o[2] for o in outs])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)


# elements of a leaf updated at once by ``update_`` (its float32
# temporaries are a few of these, not of the whole leaf)
_CHUNK = 1 << 24


def update_(
    params,
    grads,
    state: AdamWState,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> AdamWState:
    """``update`` in place: each parameter and moment leaf is overwritten
    with the bits ``update`` would return, a chunk of ``_CHUNK`` elements
    at a time, so the step holds no second copy of the moments.  Returns
    the state with the new step count (the same moment trees)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    flat = [pytree.leaves(x) for x in (params, grads, state.mu, state.nu)]
    if len({len(f) for f in flat}) != 1:
        raise ValueError(
            "adamw.update_: params, grads and moments must have the same "
            f"leaves, got {[len(f) for f in flat]}")
    for p, g, m, v in zip(*flat):
        pf, gf, mf, vf = (x.view(-1) for x in (p, g, m, v))
        c1, c2 = bc1.to(m.device), bc2.to(v.device)
        for lo in range(0, pf.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            news = _step(pf[sl], gf[sl], mf[sl], vf[sl], c1, c2, lr, b1, b2,
                         eps, weight_decay)
            for dst, new in zip((pf, mf, vf), news):
                dst[sl].copy_(new)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)


__all__ = ["AdamWState", "abstract_state", "init", "update", "update_"]
