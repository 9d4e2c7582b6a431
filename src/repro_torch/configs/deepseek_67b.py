"""deepseek-67b: llama-arch dense GQA [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    sub_quadratic=False,
)
