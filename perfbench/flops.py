"""Model FLOPs of a training step of a ``hybrid_moe`` configuration
(granite-4.0-h), counted from its Hugging Face keys and the step's shape,
whatever implements the layers.

A step is a forward and a backward, three times the forward's products
(the backward's two products a forward product); a layer recomputed in
backward is not counted again, so the share of peak these give is the
model FLOPs utilization.  A multiply-add is 2 FLOPs.  Counted a forward:

* every matrix product of the projections, the router, the shared expert
  and the vocabulary head, at T = batch x seq tokens;
* the held experts' three products at the routed choices they received
  (``routed``, the choices of all layers a step, as the program counts
  them), not at every token;
* attention's q k^T and p v under the causal mask, half the S x S square;
* the SSD scan's chunked form (chunk Q = mamba_chunk_size): C B^T and its
  product with x within a chunk (causal, half of Q x Q), the chunk states
  (B x) and their read-out (C h), at H heads of P over N states;
* the depthwise conv, d_conv multiply-adds a channel and token.

Elementwise work (norms, gates, softmaxes, the scan's decays) is left
out, as MFU counts leave it out."""
from __future__ import annotations


def forward_flops(hf: dict, batch: int, seq: int, routed: float) -> float:
    D = hf["hidden_size"]
    T = batch * seq
    H, P = hf["mamba_n_heads"], hf["mamba_d_head"]
    G, N = hf["mamba_n_groups"], hf["mamba_d_state"]
    di = H * P
    conv = di + 2 * G * N
    Q = min(hf["mamba_chunk_size"], seq)
    Fe, Fs = hf["intermediate_size"], hf["shared_intermediate_size"]
    E = hf["num_experts_total"]
    Ha, Kh = hf["num_attention_heads"], hf["num_key_value_heads"]
    dh = D // Ha
    kinds = hf["layer_types"][:hf["num_hidden_layers"]]
    mamba = (2 * T * D * (2 * di + 2 * G * N + H)      # in_proj
             + 2 * T * conv * hf["mamba_d_conv"]       # conv
             + T * Q * G * N + T * Q * di              # C B^T, (.) x: causal
             + 2 * T * di * N * 2                      # states, read-out
             + 2 * T * di * D)                         # out_proj
    attn = (2 * T * D * (Ha + 2 * Kh) * dh             # q, k, v
            + 2 * batch * seq * seq * Ha * dh          # q k^T, p v: causal
            + 2 * T * Ha * dh * D)                     # o
    moe_dense = 2 * T * D * E + 3 * 2 * T * D * Fs     # router, shared
    total = sum(mamba if k == "mamba" else attn for k in kinds)
    total += len(kinds) * moe_dense
    total += 3 * 2 * routed * D * Fe                   # held experts
    total += 2 * T * D * hf["vocab_size"]              # tied head
    return float(total)


def train_step_flops(hf: dict, batch: int, seq: int, routed: float) -> float:
    """Forward and backward: three forwards' products."""
    return 3.0 * forward_flops(hf, batch, seq, routed)
