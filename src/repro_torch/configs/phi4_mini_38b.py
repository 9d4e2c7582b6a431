"""phi4-mini-3.8b: RoPE SwiGLU GQA [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4_mini_38b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tied_embeddings=True,
    sub_quadratic=False,
)
