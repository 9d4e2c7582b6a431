"""mamba2-1.3b: SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].

48L d_model=2048 ssm_state=128 headdim=64 expand=2 vocab=50280.
Runs long_500k (O(1) state per step).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_13b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    tied_embeddings=True,
    sub_quadratic=True,
)
