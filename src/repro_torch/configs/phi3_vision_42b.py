"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend (STUB)
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064.  input_specs()
supplies 576 precomputed patch embeddings prepended to the token stream.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3_vision_42b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
    sub_quadratic=False,
)
