"""granite-4.0-h-small: 40 layers, 36 Mamba-2 and 4 NoPE GQA attention
(at 5, 15, 25, 35), each followed by 72 routed experts (top 10) and a
shared expert; muP multipliers
[https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json].

d_model=4096; Mamba-2 128 heads x 64, d_state 128, one group, conv 4 with
a bias; attention 32 heads (kv 8) of 128 scaled by 0.0078125; experts of
768, the shared one 1536; tied vocab 100352; RMSNorm eps 1e-5.  The
checkpoint's fused ``input_linear`` is held as separate ``wg``/``wi``.
A port-only architecture (no JAX counterpart).
"""
from .base import ArchConfig

_LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                     for i in range(40))

CONFIG = ArchConfig(
    name="granite_4_0_h_small",
    family="hybrid_moe",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100352,
    tied_embeddings=True,
    num_experts=72,
    moe_top_k=10,
    d_ff_expert=768,
    capacity_factor=0.0,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_groups=1,
    layer_types=_LAYER_TYPES,
    shared_d_ff=1536,
    ssm_conv_bias=True,
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    norm_eps=1e-5,
    sub_quadratic=False,
)
