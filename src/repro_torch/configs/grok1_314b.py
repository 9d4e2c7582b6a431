"""grok-1-314b: 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) per-expert d_ff=32768 vocab=131072.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok1_314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    d_ff_expert=32768,
    vocab_size=131072,
    num_experts=8,
    moe_top_k=2,
    capacity_factor=1.0,
    sub_quadratic=False,
)
