"""olmoe-1b-7b: 64-expert top-8 MoE [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16) per-expert d_ff=1024 vocab=50304.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    d_ff_expert=1024,
    vocab_size=50304,
    num_experts=64,
    moe_top_k=8,
    sub_quadratic=False,
)
