"""recurrentgemma-9b: RG-LRU + local attention hybrid, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, lru_width=4096,
window=2048.  Pattern (R,R,L) x 12 groups + (R,R) tail = 38 layers.
Runs long_500k (constant-size recurrence state + windowed attention).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    lru_width=4096,
    local_window=2048,
    layer_pattern="rrl",
    tied_embeddings=True,
    mlp_act="gelu",
    scale_embedding=True,
    sub_quadratic=True,
)
