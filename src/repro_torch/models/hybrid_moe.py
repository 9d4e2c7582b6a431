"""The hybrid_moe family: granite-4.0-h's decoder (Hugging Face
``GraniteMoeHybrid``) in plain PyTorch.

``layer_types`` says, layer by layer, whether the mixer is Mamba-2
(``ssm.mamba2_block``, with a conv bias and a gated RMSNorm of eps
``norm_eps``) or attention (GQA with no position encoding, scaled by
``attn_scale``).  Every layer then runs an MoE: the dropless expert layer
of expert parallelism (``moe.moe_held``: the chip's held experts of the
``num_experts`` the router scores) plus a shared SwiGLU expert.  A layer:

    h = x + residual_multiplier * mixer(rmsnorm(x))
    y = h + residual_multiplier * (moe(rmsnorm(h)) + shared(rmsnorm(h)))

with RMSNorms of plain weights (no 1 + w).  The embedding is scaled by
``embedding_multiplier``, the tied logits divided by ``logits_scaling``.
The vocabulary is ``vocab_size`` rows, unpadded (a chip's slice of the
published one).  Parameters keep the port's stacked layout: the Mamba
layers' leaves under ``mamba`` (L_m, ...), the attention layers' under
``attn`` (L_a, ...), each stack in the order the layers run.  Training
recomputes each layer in backward (``layers.layer_call``).  Only training
is built: no decode cache.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.trace import span

from . import moe as moe_lib
from . import ssm
from .layers import attn_out, attn_qkv, causal_attention, layer_call, \
    rmsnorm, swiglu
from .params import PD


def kinds(cfg: ArchConfig) -> tuple:
    """Each of the model's layers' mixer, in order."""
    return tuple(cfg.layer_types[:cfg.num_layers])


def _moe_pd(L, cfg: ArchConfig) -> Dict[str, Any]:
    D, F_, Fs = cfg.d_model, cfg.d_ff_expert, cfg.shared_d_ff
    E, H = cfg.num_experts, cfg.held_experts
    return {
        "ln2": PD((L, D), ("layers", None), "ones"),
        "router": PD((L, D, E), ("layers", "embed", None)),
        "moe_wg": PD((L, H, D, F_),
                     ("layers", "experts", "embed", "expert_mlp")),
        "moe_wi": PD((L, H, D, F_),
                     ("layers", "experts", "embed", "expert_mlp")),
        "moe_wo": PD((L, H, F_, D),
                     ("layers", "experts", "expert_mlp", "embed")),
        "shared_wg": PD((L, D, Fs), ("layers", "embed", "mlp")),
        "shared_wi": PD((L, D, Fs), ("layers", "embed", "mlp")),
        "shared_wo": PD((L, Fs, D), ("layers", "mlp", "embed")),
    }


def _mamba_pd(L, cfg: ArchConfig) -> Dict[str, Any]:
    dims = ssm.dims_from_config(cfg)
    D = cfg.d_model
    t = {
        "ln1": PD((L, D), ("layers", None), "ones"),
        "in_proj": PD((L, D, dims.in_proj_dim), ("layers", "embed", "mlp")),
        "conv": PD((L, dims.d_conv, dims.conv_dim), ("layers", None, None)),
        "A_log": PD((L, dims.nheads), ("layers", None), "ssm_a"),
        "D": PD((L, dims.nheads), ("layers", None), "ones"),
        "dt_bias": PD((L, dims.nheads), ("layers", None), "dt_bias"),
        "norm": PD((L, dims.d_inner), ("layers", None), "ones"),
        "out_proj": PD((L, dims.d_inner, D), ("layers", "mlp", "embed")),
    }
    if cfg.ssm_conv_bias:
        t["conv_b"] = PD((L, dims.conv_dim), ("layers", None), "zeros")
    return t


def _attn_pd(L, cfg: ArchConfig) -> Dict[str, Any]:
    D, H, Kh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    return {
        "ln1": PD((L, D), ("layers", None), "ones"),
        "wq": {"w": PD((L, D, H, dh), ("layers", "embed", "heads", None))},
        "wk": {"w": PD((L, D, Kh, dh), ("layers", "embed", "kv_heads", None))},
        "wv": {"w": PD((L, D, Kh, dh), ("layers", "embed", "kv_heads", None))},
        "wo": PD((L, H, dh, D), ("layers", "heads", None, "embed")),
    }


def param_tree(cfg: ArchConfig) -> Dict[str, Any]:
    D = cfg.d_model
    t: Dict[str, Any] = {
        "embed": PD((cfg.vocab_size, D), ("vocab", "embed")),
        "final_norm": PD((D,), (None,), "ones"),
    }
    k = kinds(cfg)
    if k.count("mamba"):
        t["mamba"] = {**_mamba_pd(k.count("mamba"), cfg),
                      **_moe_pd(k.count("mamba"), cfg)}
    if k.count("attention"):
        t["attn"] = {**_attn_pd(k.count("attention"), cfg),
                     **_moe_pd(k.count("attention"), cfg)}
    return t


def _attention(xn, lp, cfg: ArchConfig):
    q = attn_qkv(xn, lp["wq"])
    k = attn_qkv(xn, lp["wk"])
    v = attn_qkv(xn, lp["wv"])
    scale = cfg.attn_scale or cfg.resolved_head_dim ** -0.5
    return attn_out(causal_attention(q, k, v, scale), lp["wo"])


def _moe(x, lp, cfg: ArchConfig):
    """The held experts' part plus the shared expert."""
    mp = {"router": lp["router"], "wg": lp["moe_wg"], "wi": lp["moe_wi"],
          "wo": lp["moe_wo"]}
    routed = moe_lib.moe_held(x, mp, cfg.moe_top_k, cfg.expert_offset,
                              cfg.held_experts)
    with span("moe.shared"):
        return routed + swiglu(x, lp["shared_wg"], lp["shared_wi"],
                               lp["shared_wo"])


def layer(x, lp, cfg: ArchConfig, kind: str):
    """One decoder layer (``kind`` "mamba" or "attention")."""
    with span("layer.mamba" if kind == "mamba" else "layer.attn"):
        m = cfg.residual_multiplier
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps, zero_centered=False)
        if kind == "mamba":
            h, _ = ssm.mamba2_block(xn, lp, cfg, "train")
        else:
            h = _attention(xn, lp, cfg)
        x = x + h * m
        xn = rmsnorm(x, lp["ln2"], cfg.norm_eps, zero_centered=False)
        return x + _moe(xn, lp, cfg) * m


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def forward_train(params, batch, cfg: ArchConfig):
    """Teacher-forced logits (B, S, vocab_size) of batch['tokens'] (B, S),
    each layer recomputed in backward."""
    x = params["embed"][batch["tokens"]] * cfg.embedding_multiplier
    seen = {"mamba": 0, "attention": 0}
    for kind in kinds(cfg):
        stack = params["mamba" if kind == "mamba" else "attn"]
        lp = _index(stack, seen[kind])
        seen[kind] += 1
        x = layer_call(lambda x, lp, kind=kind: layer(x, lp, cfg, kind),
                       x, lp)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, zero_centered=False)
    return torch.einsum("bsd,vd->bsv", x, params["embed"]) \
        / cfg.logits_scaling
