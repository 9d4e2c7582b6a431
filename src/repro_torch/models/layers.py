"""Shared neural net building blocks (plain PyTorch).

The port's counterpart of ``repro.models.layers``, with its dataflow and
layouts: activations (B, S, D), heads (B, S, H, dh), weights as the
reference stacks them.  Attention comes in three flavors:
  * blockwise_attention -- online-softmax attention over (q block, kv
    block) pairs (train/prefill; causal, bidirectional or sliding window
    through masks; ``wedge`` visits only the causal block pairs)
  * decode_attention    -- one new query against a full KV cache
  * cache_insert        -- the ring buffer of a local-attention layer
All softmax math is float32, masks use -1e30 (a fully masked row is
uniform, not NaN), and gemma2's logit softcap applies before the mask,
which ``scaled_dot_product_attention`` cannot express.  None of this is a
TPU kernel in the reference (it is ``jnp`` code), so it stays plain
PyTorch here.  The cost-mode knobs are set only by the dry-run
(``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard

_NEG_INF = -1e30

# Cost-mode context (set by the dry-run only): ``dense_attn`` replaces the
# blockwise loops with one masked einsum (``_dense_attention``), and
# ``unroll`` = u makes each cut layer loop run its first u trips
# (``cost_trips``).  The reference unrolls its layer scans u times so that
# XLA, which counts a loop body once, counts F + u x B; the port's loops are
# Python, counted at every trip, so running u trips gives the same F + u x B
# without walking every layer (``repro_torch.roofline.analyzer``'s
# ``combine_loop_costs`` extrapolates to the full depth).  Cost mode is on
# while either knob is off its default.
_COST_MODE = {"dense_attn": False, "unroll": 1}


def set_cost_mode(dense_attn: bool = False, unroll: int = 1):
    _COST_MODE["dense_attn"] = dense_attn
    _COST_MODE["unroll"] = unroll


def cost_unroll() -> int:
    return _COST_MODE["unroll"]


def cost_trips(n: int) -> int:
    """The trips a cut layer loop of ``n`` layers runs: all of them
    outside cost mode, the first ``cost_unroll()`` in it."""
    if _COST_MODE["dense_attn"] or cost_unroll() > 1:
        return min(n, cost_unroll())
    return n


# Recomputation in training: each layer's forward runs again in backward
# (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does,
# so that only the layers' inputs are kept between the passes.  ``again``
# is true while a layer's forward runs the second time, when counters must
# not count.
_RECOMPUTE = {"again": False}


def recomputing() -> bool:
    """Whether a layer's forward is running again inside backward."""
    return _RECOMPUTE["again"]


@contextlib.contextmanager
def _again():
    was, _RECOMPUTE["again"] = _RECOMPUTE["again"], True
    try:
        yield
    finally:
        _RECOMPUTE["again"] = was


def layer_call(fn, *args):
    """``fn(*args)``, recomputed in backward where training needs it: grad
    enabled and real tensors (the dry-run's meta tensors are counted as
    they run)."""
    x = args[0]
    if not (torch.is_grad_enabled() and x.device.type != "meta"):
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _again()))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm in float32, cast back to x's dtype; gemma-style (1 + w)
    scaling when zero_centered."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    scale = (1.0 + w) if zero_centered else w
    return (normed * scale).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """cap * tanh(x / cap) in x's dtype.  The cap is a tensor of x's dtype,
    as the reference's ``jnp.asarray(cap, x.dtype)``: CUDA would divide by
    a Python scalar as a multiply by its reciprocal.  Without autograd the
    tanh and the multiply run in place (the full prefill logits of gemma2
    are 10.5 GB in bfloat16)."""
    c = torch.tensor(cap, dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled() and x.requires_grad:
        return c * torch.tanh(x / c)
    return (x / c).tanh_().mul_(c)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding over concatenated halves (not interleaved pairs).
    x (..., S, H, dh); positions (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, half)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Causal attention with no position encoding and a given ``scale``,
    through PyTorch's fused ``scaled_dot_product_attention`` (a flash
    kernel on the card): q (B, S, H, dh), k/v (B, S, Kh, dh), each kv head
    shared by H / Kh query heads.  It keeps O(S) state for backward, where
    ``blockwise_attention``'s autograd graph keeps every score tile (at 2 x
    8,192 tokens and 32 heads some 43 GB for one layer)."""
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=scale)
    return o.transpose(1, 2)


def _band_mask(qpos, kpos, causal: bool, window: int):
    """(qb, kvb) bool mask: causal and/or sliding-window band."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def _pv(p, v):
    """p @ v over the key axis with the probabilities rounded to v's dtype
    and a float32 result, as the reference's ``preferred_element_type``
    product: the factors are exact in float32, so the product is taken
    there."""
    return torch.einsum("bkgqs,bskd->bkgqd",
                        p.to(v.dtype).to(torch.float32), v.to(torch.float32))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, q_block: int = 512,
                        kv_block: int = 1024, q_offset: int = 0,
                        wedge: bool = False) -> torch.Tensor:
    """Online-softmax blockwise attention (the reference's FlashAttention
    dataflow).  q (B, Sq, H, dh), k/v (B, Skv, Kh, dh).  The sequence is
    cut into blocks with ``//``: a sequence longer than a block must be a
    multiple of it, as in the reference.  ``wedge=True`` visits only the
    lower-triangular block pairs (causal, no window, square blocks)."""
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    nq, nk = Sq // q_block, Skv // kv_block
    scale = dh ** -0.5

    q5 = q.reshape(B, nq, q_block, Kh, G, dh)
    k4 = k.reshape(B, nk, kv_block, Kh, dh)
    v4 = v.reshape(B, nk, kv_block, Kh, dh)

    if _COST_MODE["dense_attn"]:
        return _dense_attention(q, k, v, causal=causal, window=window,
                                logit_cap=logit_cap, q_offset=q_offset)

    if wedge and causal and window == 0 and Sq == Skv and q_block == kv_block:
        return _wedge_attention(q5, k4, v4, scale, logit_cap, q_offset)

    dev = q.device
    outs = []
    for qi in range(nq):
        qb_ = q5[:, qi].to(torch.float32)
        qpos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, Kh, G, q_block), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Kh, G, q_block), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, Kh, G, q_block, dh), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            s = torch.einsum("bqkgd,bskd->bkgqs", qb_,
                             k4[:, kj].to(torch.float32)) * scale
            if logit_cap:
                s = softcap(s, logit_cap)
            kpos = kj * kv_block + torch.arange(kv_block, device=dev)
            mask = _band_mask(qpos, kpos, causal, window)
            s = torch.where(mask[None, None, None], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, v4[:, kj])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)  # (B,nq,Kh,G,qb,dh)
    out = out.permute(0, 1, 4, 2, 3, 5)  # (B,nq,qb,Kh,G,dh)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _dense_attention(q, k, v, *, causal, window, logit_cap, q_offset):
    """Attention with the full (Sq, Skv) score matrix; numerically
    equivalent to blockwise_attention (cost-mode counting, small-shape
    tests)."""
    B, Sq, H, dh = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    q4 = q.reshape(B, Sq, Kh, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", q4.to(torch.float32),
                     k.to(torch.float32)) * (dh ** -0.5)
    if logit_cap:
        s = softcap(s, logit_cap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = _band_mask(qpos, kpos, causal, window)
    s = torch.where(mask[None, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p, v).permute(0, 3, 1, 2, 4)  # (B,Sq,Kh,G,dh)
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def _wedge_attention(q5, k4, v4, scale, logit_cap, q_offset):
    """Causal attention over only the lower-triangular block pairs (qi, kj
    <= qi), in the reference's order, carrying every q block's
    online-softmax state."""
    B, nq, qb, Kh, G, dh = q5.shape
    assert k4.shape[1] == nq
    dev = q5.device
    m = [torch.full((B, Kh, G, qb), _NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(nq)]
    l = [torch.zeros((B, Kh, G, qb), dtype=torch.float32, device=dev)
         for _ in range(nq)]
    acc = [torch.zeros((B, Kh, G, qb, dh), dtype=torch.float32, device=dev)
           for _ in range(nq)]
    for qi in range(nq):
        for kj in range(qi + 1):
            s = torch.einsum("bqkgd,bskd->bkgqs", q5[:, qi].to(torch.float32),
                             k4[:, kj].to(torch.float32)) * scale
            if logit_cap:
                s = softcap(s, logit_cap)
            qpos = q_offset + qi * qb + torch.arange(qb, device=dev)
            kpos = kj * qb + torch.arange(qb, device=dev)
            s = torch.where((kpos[None, :] <= qpos[:, None])[None, None, None],
                            s, _NEG_INF)
            m_new = torch.maximum(m[qi], s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m[qi] - m_new)
            l[qi] = l[qi] * corr + p.sum(dim=-1)
            acc[qi] = acc[qi] * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, v4[:, kj].to(torch.float32))
            m[qi] = m_new
    out = torch.stack([a / torch.clamp(li, min=1e-30)[..., None]
                       for a, li in zip(acc, l)], dim=1)  # (B,nq,Kh,G,qb,dh)
    out = out.permute(0, 1, 4, 2, 3, 5)  # (B,nq,qb,Kh,G,dh)
    return out.reshape(B, nq * qb, Kh * G, dh).to(q5.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     logit_cap: float = 0.0) -> torch.Tensor:
    """One new query (B, 1, H, dh) against a (B, S, Kh, dh) cache; token
    ``pos`` is the newest.  With ``window`` the cache is a ring buffer:
    its first min(pos + 1, S) slots are live."""
    B, _, H, dh = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    q_ = q.reshape(B, Kh, G, dh).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", q_,
                     k_cache.to(torch.float32)) * (dh ** -0.5)
    if logit_cap:
        s = softcap(s, logit_cap)
    idx = torch.arange(S, device=q.device)
    valid = idx < min(pos + 1, S) if window > 0 else idx <= pos
    s = torch.where(valid[None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, dh).to(q.dtype)


def cache_insert(cache: torch.Tensor, new: torch.Tensor, pos: int,
                 window: int = 0) -> torch.Tensor:
    """Write (B, 1, Kh, dh) at position ``pos`` (ring slot ``pos % S`` with
    a window), clamped into the cache as ``dynamic_update_slice`` clamps.
    Unlike the reference, the cache is updated in place and returned."""
    S = cache.shape[1]
    slot = pos % max(S, 1) if window > 0 else pos
    slot = min(max(slot, 0), S - 1)
    cache[:, slot:slot + 1] = new.to(cache.dtype)
    return cache


def attn_qkv(xn, w):
    """x (B,S,D) @ w (D,H,dh) -> (B,S,H,dh), + optional bias."""
    out = torch.einsum("bsd,dhk->bshk", xn, w["w"])
    if "b" in w:
        out = out + w["b"]
    return out


def attn_out(o, wo):
    """(B,S,H,dh) @ (H,dh,D) -> (B,S,D)."""
    return torch.einsum("bshk,hkd->bsd", o, wo)


def swiglu(xn, wg, wi, wo):
    h = silu(torch.einsum("bsd,df->bsf", xn, wg)) * torch.einsum(
        "bsd,df->bsf", xn, wi)
    h = shard(h, "act_batch", "act_seq", "act_mlp")
    return torch.einsum("bsf,fd->bsd", h, wo)


def gelu_mlp(xn, wi, wo):
    """``jax.nn.gelu`` defaults to the tanh approximation."""
    h = F.gelu(torch.einsum("bsd,df->bsf", xn, wi), approximate="tanh")
    h = shard(h, "act_batch", "act_seq", "act_mlp")
    return torch.einsum("bsf,fd->bsd", h, wo)
