"""Architecture + shape configuration system (the port's copy of
``repro.configs.base``; plain dataclasses, no framework).

Every assigned architecture is an ``ArchConfig`` in its own module under
``repro_torch.configs``; ``get_config(name)`` resolves them, and ``SHAPES``
holds the assigned input-shape set (same four cells for every LM-family
arch).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# shapes (assigned): seq_len x global_batch cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | hybrid_moe | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # ---- dense-transformer options ----
    qkv_bias: bool = False
    tied_embeddings: bool = False
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    local_window: int = 0             # >0 enables local attention layers
    layer_pattern: str = "global"     # "global" | "local_global" | "rrl"

    # ---- MoE ----
    num_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # ---- SSM (mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # ---- hybrid (recurrentgemma) ----
    lru_width: int = 0

    # ---- hybrid_moe (granite-4.0-h: Mamba-2 and attention layers by
    # ``layer_types``, each followed by routed experts and a shared one) ----
    layer_types: Tuple[str, ...] = ()  # "mamba" | "attention", a layer
    shared_d_ff: int = 0               # the shared expert's width
    # expert parallelism: the routed experts this chip holds, [offset,
    # offset + experts_held) of num_experts (0: all of them)
    expert_offset: int = 0
    experts_held: int = 0
    ssm_conv_bias: bool = False
    attn_scale: float = 0.0          # 0: 1 / sqrt(head_dim)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    # ---- enc-dec ----
    enc_layers: int = 0
    dec_layers: int = 0
    enc_context: int = 4_096  # encoder frames for prefill/decode shapes

    # ---- modality frontend stubs ----
    num_patches: int = 0      # vlm: patch embeddings prepended to text

    # ---- numerics / training ----
    dtype: str = "bfloat16"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    mlp_act: str = "silu"          # "silu" (SwiGLU) | "gelu" (GeGLU)
    scale_embedding: bool = False  # gemma-family sqrt(d_model) embed scale

    # ---- applicability ----
    sub_quadratic: bool = False  # may run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def padded_vocab(self, multiple: int = 2_048) -> int:
        """Vocab padded so it shards over the model axis (DESIGN.md Sec. 5)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def supports(self, shape: ShapeCell) -> bool:
        """Arch x shape applicability (skips documented in DESIGN.md)."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False
        return True

    @property
    def held_experts(self) -> int:
        """The routed experts this chip computes (all where none is set)."""
        return self.experts_held or self.num_experts

    def layer_period(self) -> int:
        """The length of the shortest repeating unit of ``layer_types``."""
        t = self.layer_types
        return next(p for p in range(1, len(t) + 1)
                    if all(t[i] == t[i % p] for i in range(len(t))))

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
        changes = dict(
            # hybrid needs >= 3 layers for one full (R, R, L) group, a
            # layer_types model one period
            num_layers=3 if self.layer_pattern == "rrl"
            else self.layer_period() if self.layer_types
            else min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            enc_context=64,
        )
        if self.num_experts:
            changes.update(num_experts=min(self.num_experts, 4),
                           moe_top_k=min(self.moe_top_k, 2), d_ff_expert=64)
            if self.experts_held:
                changes.update(expert_offset=0, experts_held=2)
        if self.shared_d_ff:
            changes.update(shared_d_ff=96)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=16)
        if self.lru_width:
            changes.update(lru_width=128)
        if self.local_window:
            changes.update(local_window=16)
        if self.enc_layers:
            changes.update(enc_layers=2, dec_layers=2)
        if self.num_patches:
            changes.update(num_patches=16)
        return dataclasses.replace(self, **changes)


ARCH_NAMES = (
    "seamless_m4t_large_v2",
    "deepseek_67b",
    "gemma2_2b",
    "qwen25_32b",
    "phi4_mini_38b",
    "olmoe_1b_7b",
    "grok1_314b",
    "phi3_vision_42b",
    "mamba2_13b",
    "recurrentgemma_9b",
)


# architectures of the port alone: no JAX counterpart to pair them with
PORT_ARCH_NAMES = (
    "granite_4_0_h_small",
)


def get_config(name: str) -> ArchConfig:
    norm = name.replace("-", "_").replace(".", "_")
    if norm not in ARCH_NAMES + PORT_ARCH_NAMES:
        norm = name.replace("-", "_").replace(".", "")
    if norm not in ARCH_NAMES + PORT_ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{ARCH_NAMES + PORT_ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{norm}")
    return mod.CONFIG


def all_configs():
    return {n: get_config(n) for n in ARCH_NAMES}
