"""gemma2-2b: local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
sliding window 4096 on local layers, attn softcap 50.0, final softcap 30.0.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2_2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    local_window=4096,
    layer_pattern="local_global",
    tied_embeddings=True,
    mlp_act="gelu",
    scale_embedding=True,
    sub_quadratic=False,  # global layers are full attention (DESIGN.md)
)
