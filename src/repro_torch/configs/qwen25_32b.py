"""qwen2.5-32b: dense GQA with QKV bias [hf:Qwen/Qwen2.5; hf].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen25_32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    sub_quadratic=False,
)
