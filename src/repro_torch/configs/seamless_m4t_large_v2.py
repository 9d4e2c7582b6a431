"""seamless-m4t-large-v2: audio enc-dec backbone [arXiv:2308.11596; hf].

Modality frontend (speech feature extractor) is a STUB: input_specs()
supplies precomputed frame embeddings to the 24L encoder; the 24L text
decoder has self + cross attention. 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_large_v2",
    family="encdec",
    num_layers=24,
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    enc_context=4096,
    sub_quadratic=False,
)
