"""Model assembly for all 10 architectures (PyTorch).

The port's counterpart of ``repro.models.transformer``:
  * ``param_tree(cfg)``          -- PD tree (shapes + sharding axes + init)
  * ``cache_tree(cfg, B, S)``    -- PD tree of the decode KV/state caches
  * ``forward_train(params, batch, cfg)``   -> logits
  * ``forward_prefill(params, batch, cfg)`` -> (logits, cache)
  * ``forward_decode(params, batch, cfg)``  -> (logits, cache)

Families: dense (deepseek, qwen, phi4 with global layers; gemma2 with
local/global pairs, post-norms and softcaps), moe (olmoe, grok-1:
``models/moe.py``), vlm (phi-3-vision: patch embeddings prepended to the
text), ssm (mamba2: ``models/ssm.py``), hybrid (recurrentgemma's (R, R, L)
groups and recurrent tail: ``models/rglru.py``), encdec (seamless: an
encoder over frame embeddings, a text decoder with cross attention), and,
of the port alone, hybrid_moe (granite-4.0-h: ``models/hybrid_moe.py``,
training only).
Parameters keep the reference's stacked (L, ...) layout, so its arrays
cross as a numpy copy (``convert.params_from_numpy``), and a Python loop
over the layers takes the place of ``lax.scan``.  Training recomputes each
layer in backward, as the reference's ``jax.checkpoint`` does
(``layers.layer_call``: only the layers' inputs are kept between the
passes); the gradients are the same.  Decode updates the cache it is given in place
and returns it: the kv rings through ``cache_insert``, the recurrent and
SSM states by a copy into each layer's slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard

from . import hybrid_moe
from . import moe as moe_lib
from . import rglru, ssm
from .layers import (attn_out, attn_qkv, blockwise_attention, cache_insert,
                     cost_trips, decode_attention, layer_call, rmsnorm, rope,
                     softcap, swiglu)
from .params import PD


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------

def _attn_pd(L, cfg: ArchConfig) -> Dict[str, Any]:
    D, H, Kh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    t = {
        "wq": {"w": PD((L, D, H, dh), ("layers", "embed", "heads", None))},
        "wk": {"w": PD((L, D, Kh, dh), ("layers", "embed", "kv_heads", None))},
        "wv": {"w": PD((L, D, Kh, dh), ("layers", "embed", "kv_heads", None))},
        "wo": PD((L, H, dh, D), ("layers", "heads", None, "embed")),
    }
    if cfg.qkv_bias:
        t["wq"]["b"] = PD((L, H, dh), ("layers", "heads", None), "zeros")
        t["wk"]["b"] = PD((L, Kh, dh), ("layers", "kv_heads", None), "zeros")
        t["wv"]["b"] = PD((L, Kh, dh), ("layers", "kv_heads", None), "zeros")
    return t


def _mlp_pd(L, cfg: ArchConfig) -> Dict[str, Any]:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "wg": PD((L, D, F_), ("layers", "embed", "mlp")),
        "wi": PD((L, D, F_), ("layers", "embed", "mlp")),
        "wo_mlp": PD((L, F_, D), ("layers", "mlp", "embed")),
    }


def _moe_pd(L, cfg: ArchConfig) -> Dict[str, Any]:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    return {
        "router": PD((L, D, E), ("layers", "embed", None)),
        "moe_wg": PD((L, E, D, F_),
                     ("layers", "experts", "embed", "expert_mlp")),
        "moe_wi": PD((L, E, D, F_),
                     ("layers", "experts", "embed", "expert_mlp")),
        "moe_wo": PD((L, E, F_, D),
                     ("layers", "experts", "expert_mlp", "embed")),
    }


def _norms_pd(L, cfg: ArchConfig, post: bool = False) -> Dict[str, Any]:
    D = cfg.d_model
    t = {
        "ln1": PD((L, D), ("layers", None), "zeros"),
        "ln2": PD((L, D), ("layers", None), "zeros"),
    }
    if post:  # gemma-style post norms
        t["ln1p"] = PD((L, D), ("layers", None), "zeros")
        t["ln2p"] = PD((L, D), ("layers", None), "zeros")
    return t


def _dense_stack_pd(L, cfg: ArchConfig, post_norms=False):
    return {**_attn_pd(L, cfg), **_mlp_pd(L, cfg),
            **_norms_pd(L, cfg, post_norms)}


def _ssm_stack_pd(L, cfg: ArchConfig):
    dims = ssm.dims_from_config(cfg)
    D = cfg.d_model
    return {
        "ln1": PD((L, D), ("layers", None), "zeros"),
        "in_proj": PD((L, D, dims.in_proj_dim), ("layers", "embed", "mlp")),
        "conv": PD((L, dims.d_conv, dims.conv_dim), ("layers", None, None)),
        "A_log": PD((L, dims.nheads), ("layers", None), "ssm_a"),
        "D": PD((L, dims.nheads), ("layers", None), "ones"),
        "dt_bias": PD((L, dims.nheads), ("layers", None), "dt_bias"),
        "norm": PD((L, dims.d_inner), ("layers", None), "ones"),
        "out_proj": PD((L, dims.d_inner, D), ("layers", "mlp", "embed")),
    }


def _rec_stack_pd(L, cfg: ArchConfig):
    D, W = cfg.d_model, cfg.lru_width
    return {
        "ln1": PD((L, D), ("layers", None), "zeros"),
        "ln1p": PD((L, D), ("layers", None), "zeros"),
        "ln2": PD((L, D), ("layers", None), "zeros"),
        "ln2p": PD((L, D), ("layers", None), "zeros"),
        "in_x": PD((L, D, W), ("layers", "embed", "lru")),
        "in_g": PD((L, D, W), ("layers", "embed", "lru")),
        "conv": PD((L, 4, W), ("layers", None, "lru")),
        "w_a": PD((L, W), ("layers", "lru"), "zeros"),
        "b_a": PD((L, W), ("layers", "lru"), "zeros"),
        "w_x": PD((L, W), ("layers", "lru"), "zeros"),
        "b_x": PD((L, W), ("layers", "lru"), "zeros"),
        "lam": PD((L, W), ("layers", "lru"), "ones"),
        "out": PD((L, W, D), ("layers", "lru", "embed")),
        **_mlp_pd(L, cfg),
    }


def param_tree(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.family == "hybrid_moe":
        return hybrid_moe.param_tree(cfg)
    D, Vp = cfg.d_model, cfg.padded_vocab()
    t: Dict[str, Any] = {
        "embed": PD((Vp, D), ("vocab", "embed")),
        "final_norm": PD((D,), (None,), "zeros"),
    }
    if not cfg.tied_embeddings:
        t["unembed"] = PD((D, Vp), ("embed", "vocab"))

    fam = cfg.family
    if fam in ("dense", "vlm"):
        if cfg.layer_pattern == "local_global":
            G = cfg.num_layers // 2
            t["local"] = _dense_stack_pd(G, cfg, post_norms=True)
            t["global"] = _dense_stack_pd(G, cfg, post_norms=True)
        else:
            t["layers"] = _dense_stack_pd(cfg.num_layers, cfg)
    elif fam == "moe":
        t["layers"] = {**_attn_pd(cfg.num_layers, cfg),
                       **_moe_pd(cfg.num_layers, cfg),
                       **_norms_pd(cfg.num_layers, cfg)}
    elif fam == "ssm":
        t["layers"] = _ssm_stack_pd(cfg.num_layers, cfg)
    elif fam == "hybrid":
        G, tail = _rrl_groups(cfg)
        t["rec1"] = _rec_stack_pd(G, cfg)
        t["rec2"] = _rec_stack_pd(G, cfg)
        t["attn"] = {**_attn_pd(G, cfg), **_mlp_pd(G, cfg),
                     **_norms_pd(G, cfg, post=True)}
        if tail:
            t["tail"] = _rec_stack_pd(tail, cfg)
    elif fam == "encdec":
        H, Kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        Ld = cfg.dec_layers
        t["enc"] = _dense_stack_pd(cfg.enc_layers, cfg)
        t["dec"] = {
            **_dense_stack_pd(Ld, cfg),
            "xq": {"w": PD((Ld, D, H, dh),
                           ("layers", "embed", "heads", None))},
            "xk": {"w": PD((Ld, D, Kh, dh),
                           ("layers", "embed", "kv_heads", None))},
            "xv": {"w": PD((Ld, D, Kh, dh),
                           ("layers", "embed", "kv_heads", None))},
            "xo": PD((Ld, H, dh, D), ("layers", "heads", None, "embed")),
            "lnx": PD((Ld, D), ("layers", None), "zeros"),
        }
        t["enc_final_norm"] = PD((D,), (None,), "zeros")
    else:
        raise ValueError(fam)
    return t


def _rrl_groups(cfg: ArchConfig):
    """(full RRL groups, tail recurrent layers) for the hybrid pattern."""
    G = cfg.num_layers // 3
    return G, cfg.num_layers - 3 * G


# ---------------------------------------------------------------------------
# cache trees (decode-mode carried state)
# ---------------------------------------------------------------------------

def _kv_pd(L, B, S, cfg: ArchConfig):
    Kh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    axes = ("layers", "cache_batch", "cache_seq", "act_kv_heads", None)
    return {"k": PD((L, B, S, Kh, dh), axes, "zeros"),
            "v": PD((L, B, S, Kh, dh), axes, "zeros")}


def _ssm_state_pd(L, B, cfg: ArchConfig):
    dims = ssm.dims_from_config(cfg)
    return {
        "conv": PD((L, B, dims.d_conv - 1, dims.conv_dim),
                   ("layers", "cache_batch", None, None), "zeros"),
        "ssm": PD((L, B, dims.nheads, dims.d_state, dims.headdim),
                  ("layers", "cache_batch", "act_heads", None, None),
                  "zeros"),
    }


def _rec_state_pd(L, B, cfg: ArchConfig):
    W = cfg.lru_width
    return {
        "conv": PD((L, B, 3, W), ("layers", "cache_batch", None, "act_lru"),
                   "zeros"),
        "h": PD((L, B, W), ("layers", "cache_batch", "act_lru"), "zeros"),
    }


def cache_tree(cfg: ArchConfig, B: int, S: int) -> Dict[str, Any]:
    """Decode-mode cache for a max context of S tokens."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        if cfg.layer_pattern == "local_global":
            G = cfg.num_layers // 2
            Wl = min(cfg.local_window, S)
            return {"local": _kv_pd(G, B, Wl, cfg),
                    "global": _kv_pd(G, B, S, cfg)}
        return {"layers": _kv_pd(cfg.num_layers, B, S, cfg)}
    if fam == "moe":
        return {"layers": _kv_pd(cfg.num_layers, B, S, cfg)}
    if fam == "ssm":
        return {"layers": _ssm_state_pd(cfg.num_layers, B, cfg)}
    if fam == "hybrid":
        G, tail = _rrl_groups(cfg)
        Wl = min(cfg.local_window, S)
        t = {"rec1": _rec_state_pd(G, B, cfg),
             "rec2": _rec_state_pd(G, B, cfg),
             "attn": _kv_pd(G, B, Wl, cfg)}
        if tail:
            t["tail"] = _rec_state_pd(tail, B, cfg)
        return t
    if fam == "encdec":
        return {"self": _kv_pd(cfg.dec_layers, B, S, cfg),
                "cross": _kv_pd(cfg.dec_layers, B, cfg.enc_context, cfg)}
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# layer applications
# ---------------------------------------------------------------------------

def _attn_apply(x, lp, cfg: ArchConfig, mode: str, cache, pos, *,
                window: int = 0, post_norms: bool = False, causal=True,
                wedge: bool = False):
    """One attention sub-block.  Returns (x, new_cache)."""
    B, S, _ = x.shape
    xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q = attn_qkv(xn, lp["wq"])
    k = attn_qkv(xn, lp["wk"])
    v = attn_qkv(xn, lp["wv"])
    q = shard(q, "act_batch", "act_seq", "act_heads", None)
    k = shard(k, "act_batch", "act_seq", "act_kv_heads", None)
    if mode == "decode":
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = cache
    if mode == "decode":
        kc = cache_insert(cache["k"], k, pos, window)
        vc = cache_insert(cache["v"], v, pos, window)
        o = decode_attention(q, kc, vc, pos, window=window,
                             logit_cap=cfg.attn_logit_softcap)
        new_cache = {"k": kc, "v": vc}
    else:
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                logit_cap=cfg.attn_logit_softcap,
                                wedge=wedge)
        if mode == "prefill":
            if window > 0:  # the ring keeps the last Wl keys
                Wl = min(window, S)
                new_cache = {"k": k[:, S - Wl:], "v": v[:, S - Wl:]}
            else:
                new_cache = {"k": k, "v": v}
    out = attn_out(o, lp["wo"])
    if post_norms:
        out = rmsnorm(out, lp["ln1p"], cfg.norm_eps)
    return x + out, new_cache


def _mlp_apply(x, lp, cfg: ArchConfig, post_norms: bool = False):
    xn = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.mlp_act == "gelu":  # GeGLU; jax.nn.gelu's tanh approximation
        h = F.gelu(torch.einsum("bsd,df->bsf", xn, lp["wg"]),
                   approximate="tanh") * torch.einsum("bsd,df->bsf", xn,
                                                      lp["wi"])
        h = shard(h, "act_batch", "act_seq", "act_mlp")
        out = torch.einsum("bsf,fd->bsd", h, lp["wo_mlp"])
    else:
        out = swiglu(xn, lp["wg"], lp["wi"], lp["wo_mlp"])
    if post_norms:
        out = rmsnorm(out, lp["ln2p"], cfg.norm_eps)
    return x + out


def _moe_apply(x, lp, cfg: ArchConfig):
    xn = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    mp = {"router": lp["router"], "wg": lp["moe_wg"], "wi": lp["moe_wi"],
          "wo": lp["moe_wo"]}
    return x + moe_lib.moe_ffn(xn, mp, cfg.num_experts, cfg.moe_top_k,
                               cfg.capacity_factor)


def _rec_apply(x, lp, cfg: ArchConfig, mode: str, state):
    xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    out, new_state = rglru.recurrent_block(xn, lp, mode, state)
    out = rmsnorm(out, lp["ln1p"], cfg.norm_eps)
    x = x + out
    x = _mlp_apply(x, lp, cfg, post_norms=True)
    return x, new_state


def _ssm_apply(x, lp, cfg: ArchConfig, mode: str, state):
    xn = rmsnorm(x, lp["ln1"], cfg.norm_eps, zero_centered=False)
    out, new_state = ssm.mamba2_block(xn, lp, cfg, mode, state)
    return x + out, new_state


# ---------------------------------------------------------------------------
# stacks (a loop over the stacked layers)
# ---------------------------------------------------------------------------

def _index(tree, i: int):
    """Layer i of a stacked tree: views, no copy."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _num_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _assign(dst, src):
    """Copy every leaf of ``src`` that is not already ``dst``'s into it."""
    if isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


def _scan_stack(body, x, stack, cache, mode: str, cut: bool = True):
    """The layers in order.  train: no cache; prefill: the per-layer caches
    stacked; decode: ``cache`` itself, each layer's slice updated in place
    through its view (a kv ring by ``cache_insert``, a state by a copy).
    In cost mode a ``cut`` loop runs ``layers.cost_trips`` of its layers
    (the loops the reference scans at ``cost_unroll()``; the hybrid's tail,
    which it unrolls whole, is not cut)."""
    new = []
    n = _num_layers(stack)
    for i in range(cost_trips(n) if cut else n):
        cl = None if cache is None else _index(cache, i)
        if mode == "train":
            x, nc = layer_call(lambda x, lp: body(x, lp, None),
                               x, _index(stack, i))
        else:
            x, nc = body(x, _index(stack, i), cl)
        if mode == "decode":
            _assign(cl, nc)
        else:
            new.append(nc)
    if mode == "train":
        return x, None
    if mode == "prefill":
        return x, _stack(new)
    return x, cache


def _dense_body(cfg, mode, pos, window=0, post_norms=False, wedge=False):
    def body(x, lp, cl):
        x, nc = _attn_apply(x, lp, cfg, mode, cl, pos, window=window,
                            post_norms=post_norms, wedge=wedge)
        if "router" in lp:
            x = _moe_apply(x, lp, cfg)
        else:
            x = _mlp_apply(x, lp, cfg, post_norms=post_norms)
        return x, nc
    return body


def _apply_backbone(params, x, cfg: ArchConfig, mode: str, cache, pos,
                    wedge: bool = False):
    """Run the layer stack for any decoder family.  Returns (x, new_cache)."""
    fam = cfg.family

    if fam in ("dense", "vlm", "moe"):
        if cfg.layer_pattern == "local_global":
            bl = _dense_body(cfg, mode, pos, window=cfg.local_window,
                             post_norms=True)
            bg = _dense_body(cfg, mode, pos, post_norms=True, wedge=wedge)

            def body(x, lp, cl):
                x, ncl = bl(x, lp["local"],
                            None if cl is None else cl["local"])
                x, ncg = bg(x, lp["global"],
                            None if cl is None else cl["global"])
                return x, {"local": ncl, "global": ncg}

            stack = {"local": params["local"], "global": params["global"]}
            return _scan_stack(body, x, stack, cache, mode)

        body = _dense_body(cfg, mode, pos, wedge=wedge)
        x, nc = _scan_stack(body, x, params["layers"],
                            None if cache is None else cache["layers"], mode)
        return x, (None if nc is None else {"layers": nc})

    if fam == "ssm":
        def body(x, lp, st):
            return _ssm_apply(x, lp, cfg, mode, st)
        x, nst = _scan_stack(body, x, params["layers"],
                             None if cache is None else cache["layers"],
                             mode)
        return x, (None if nst is None else {"layers": nst})

    if fam == "hybrid":
        ba = _dense_body(cfg, mode, pos, window=cfg.local_window,
                         post_norms=True)

        def body(x, lp, cl):
            x, ns1 = _rec_apply(x, lp["rec1"], cfg, mode,
                                None if cl is None else cl["rec1"])
            x, ns2 = _rec_apply(x, lp["rec2"], cfg, mode,
                                None if cl is None else cl["rec2"])
            x, nat = ba(x, lp["attn"], None if cl is None else cl["attn"])
            return x, {"rec1": ns1, "rec2": ns2, "attn": nat}

        stack = {k: params[k] for k in ("rec1", "rec2", "attn")}
        cc = None if cache is None else {k: cache[k]
                                         for k in ("rec1", "rec2", "attn")}
        x, ncache = _scan_stack(body, x, stack, cc, mode)

        if "tail" in params:
            def tbody(x, lp, st):
                return _rec_apply(x, lp, cfg, mode, st)
            tc = None if cache is None else cache["tail"]
            x, ntail = _scan_stack(tbody, x, params["tail"], tc, mode,
                                   cut=False)
            if ncache is not None:
                ncache = dict(ncache, tail=ntail)
        return x, ncache

    raise ValueError(fam)


# ---------------------------------------------------------------------------
# top-level forwards
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg: ArchConfig):
    x = params["embed"][tokens]
    if cfg.scale_embedding:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return shard(x, "act_batch", "act_seq", "act_embed")


def _logits(params, x, cfg: ArchConfig):
    """Final norm, the (tied) unembedding in the parameters' dtype, and the
    final softcap in that dtype (bfloat16 logits are capped in
    bfloat16)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tied_embeddings:
        out = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        out = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    if cfg.final_logit_softcap:
        out = softcap(out, cfg.final_logit_softcap)
    return shard(out, "act_batch", "act_seq", "act_vocab")


def _prefix_patches(x_text, patch_embeds, cfg: ArchConfig):
    """VLM: prepend the (stubbed) patch embeddings to the token stream."""
    return torch.cat([patch_embeds.to(x_text.dtype), x_text], dim=1)


def forward_train(params, batch, cfg: ArchConfig, wedge: bool = False):
    """Teacher-forced logits for the LM families.  batch['tokens'] (B, S)."""
    if cfg.family == "encdec":
        return _encdec_forward(params, batch, cfg, mode="train")[0]
    if cfg.family == "hybrid_moe":
        return hybrid_moe.forward_train(params, batch, cfg)
    x = _embed(params, batch["tokens"], cfg)
    if cfg.family == "vlm":
        x = _prefix_patches(x, batch["patch_embeds"], cfg)
    x, _ = _apply_backbone(params, x, cfg, "train", None, None, wedge=wedge)
    return _logits(params, x, cfg)


def forward_prefill(params, batch, cfg: ArchConfig, wedge: bool = False):
    """Prefill: logits over the prompt + freshly built decode cache."""
    if cfg.family == "encdec":
        return _encdec_forward(params, batch, cfg, mode="prefill")
    x = _embed(params, batch["tokens"], cfg)
    if cfg.family == "vlm":
        x = _prefix_patches(x, batch["patch_embeds"], cfg)
    x, cache = _apply_backbone(params, x, cfg, "prefill", None, None,
                               wedge=wedge)
    return _logits(params, x, cfg), cache


def forward_decode(params, batch, cfg: ArchConfig):
    """One decode step.  batch: token (B, 1), pos (an int, the new token's
    index), cache tree.  The cache is updated in place and returned."""
    pos = int(batch["pos"])
    if cfg.family == "encdec":
        return _encdec_forward(params, dict(batch, pos=pos), cfg,
                               mode="decode")
    x = _embed(params, batch["token"], cfg)
    x, new_cache = _apply_backbone(params, x, cfg, "decode", batch["cache"],
                                   pos)
    return _logits(params, x, cfg), new_cache


# ---------------------------------------------------------------------------
# encoder-decoder (seamless-m4t backbone; audio frontend stubbed)
# ---------------------------------------------------------------------------

def _cross_apply(x, lp, cfg: ArchConfig, mode: str, cross_cache):
    """Decoder cross-attention over (cached) encoder keys/values."""
    xn = rmsnorm(x, lp["lnx"], cfg.norm_eps)
    q = attn_qkv(xn, lp["xq"])
    q = shard(q, "act_batch", "act_seq", "act_heads", None)
    o = blockwise_attention(q, cross_cache["k"], cross_cache["v"],
                            causal=False)
    return x + attn_out(o, lp["xo"])


def _enc_body(cfg):
    def body(x, lp, _):
        x, _ = _attn_apply(x, lp, cfg, "train", None, None, causal=False)
        x = _mlp_apply(x, lp, cfg)
        return x, None
    return body


def _encdec_forward(params, batch, cfg: ArchConfig, mode: str):
    """The encoder over the frames (train and prefill), then the decoder:
    train returns (logits,), prefill (logits, cache), decode (logits,
    cache) from the cached self and cross keys.  The frames are rounded to
    bfloat16, as the reference rounds them, then cast to the weights'
    dtype (the reference's layer scan refuses float32 weights there: its
    bfloat16 carry meets float32 outputs)."""
    if mode == "decode":
        x = _embed(params, batch["token"], cfg)

        def body(x, lp, cl):
            x, nself = _attn_apply(x, lp, cfg, mode, cl["self"],
                                   batch["pos"])
            x = _cross_apply(x, lp, cfg, mode, cl["cross"])
            x = _mlp_apply(x, lp, cfg)
            return x, {"self": nself, "cross": cl["cross"]}

        cache = batch["cache"]
        x, cache = _scan_stack(body, x, params["dec"], cache, mode)
        return _logits(params, x, cfg), cache

    e = batch["frames"].to(torch.bfloat16).to(params["embed"].dtype)
    e = shard(e, "act_batch", "act_seq", "act_embed")
    e, _ = _scan_stack(_enc_body(cfg), e, params["enc"], None, "train")
    enc_out = rmsnorm(e, params["enc_final_norm"], cfg.norm_eps)

    # train / prefill: build cross K/V from encoder output per layer
    x = _embed(params, batch["tokens"], cfg)

    def body(x, lp, _):
        x, nself = _attn_apply(x, lp, cfg, mode, None, None)
        xk = attn_qkv(enc_out, lp["xk"])
        xv = attn_qkv(enc_out, lp["xv"])
        x = _cross_apply(x, lp, cfg, mode, {"k": xk, "v": xv})
        x = _mlp_apply(x, lp, cfg)
        return x, (None if mode == "train"
                   else {"self": nself, "cross": {"k": xk, "v": xv}})

    x, cache = _scan_stack(body, x, params["dec"], None, mode)
    if mode == "train":
        return (_logits(params, x, cfg),)
    return _logits(params, x, cfg), cache
