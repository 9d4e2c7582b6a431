"""A plain reference of granite-4.0-h's decoder (Hugging Face
``GraniteMoeHybridForCausalLM``), cut to a chip's share: its forward, its
loss and, by autograd, its gradients, in float32 torch with no kernel of
its own, no recomputation and no import of the program.

It is written from the published equations (``modeling_granitemoehybrid``
and the config's keys, which ``cfg`` holds by their Hugging Face names):

    x = embed[tokens] * embedding_multiplier
    each layer i (``layer_types[i]``, "mamba" or "attention"):
        h = x + residual_multiplier * mixer(rmsnorm(x, ln1))
        x = h + residual_multiplier * (moe(rmsnorm(h, ln2))
                                       + shared(rmsnorm(h, ln2)))
    logits = rmsnorm(x, final_norm) @ embed.T / logits_scaling
    loss = mean cross-entropy of the next tokens

RMSNorm: x / sqrt(mean(x^2) + rms_norm_eps) * w.  Mamba-2 mixer: in_proj
to [z, x B C, dt]; a depthwise causal conv of width mamba_d_conv with a
bias, then SiLU; dt = softplus(dt + dt_bias); A = -exp(A_log); the SSD
scan in its chunked form (``mamba_chunk_size`` tokens a chunk, as the
Hugging Face torch path computes it); y + D x; the gated RMSNorm
rmsnorm(y * silu(z)) * norm; out_proj.  Attention: GQA with no position
encoding, softmax(q k^T * attention_multiplier) under a causal mask (a
block of query rows at a time).  MoE:
router logits over all ``num_experts_total`` experts, the top
``num_experts_per_tok`` logits softmaxed into gates, each expert
silu(x wg) * (x wi) wo; a shared expert of the same form.

Departures, each the chip's share of a deployment or a layout:
* only experts [expert_offset, expert_offset + num_local_experts) are held
  (the router stays ``num_experts_total`` wide); choices of other experts
  add nothing, as on the chip that holds these;
* the vocabulary is ``vocab_size`` rows (a slice), and logits and loss are
  over it;
* the checkpoint's fused ``input_linear`` is read as separate wg, wi
  (first half gated);
* parameters come in the program's stacked layout (``mamba`` and ``attn``
  stacks in layer order, attention weights as (D, H, dh) and (H, dh, D));
  only the layout is shared, no code.

``matmul_round`` (``Reference(..., matmul_round=torch.float8_e4m3fn)``)
rounds every matrix product's inputs to that type in the forward (the
gradients pass through unrounded): the control of the benchmark's checks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
# query rows of attention scored at once: each row's softmax is its own, so
# blocks of rows give the same numbers in a block's memory
QUERY_BLOCK = 1024


def _round_to(dtype):
    if dtype is None:
        return lambda x: x
    top = float(torch.finfo(dtype).max)

    def rnd(x):
        r = x.detach().clamp(-top, top).to(dtype).to(x.dtype)
        return x + (r - x.detach())

    return rnd


class Reference:
    """The cut model of ``cfg`` (a dict of the Hugging Face config's keys,
    with ``num_local_experts`` the experts held here, ``expert_offset``
    the first of them and ``num_experts_total`` the router's width)."""

    def __init__(self, cfg: dict, matmul_round=None):
        self.c = cfg
        self.rnd = _round_to(matmul_round)

    # -- pieces -------------------------------------------------------
    def mm(self, a, b):
        return self.rnd(a) @ self.rnd(b)

    def rmsnorm(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["rms_norm_eps"]) * w

    def swiglu(self, x, wg, wi, wo):
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wi), wo)

    def mamba(self, x, p):
        c = self.c
        Bsz, S, D = x.shape
        H, P = c["mamba_n_heads"], c["mamba_d_head"]
        G, N = c["mamba_n_groups"], c["mamba_d_state"]
        di = H * P
        zxbcdt = self.mm(x, p["in_proj"])
        z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
        K = p["conv"].shape[0]
        w = p["conv"].t()[:, None, :]                          # (C, 1, K)
        xbc = F.conv1d(xbc.transpose(1, 2), w, p["conv_b"],
                       padding=K - 1, groups=w.shape[0])[..., :S]
        xbc = F.silu(xbc.transpose(1, 2))
        xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
        dt = F.softplus(dt + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        y = self.ssd(xs.reshape(Bsz, S, H, P), dt, A,
                     Bm.reshape(Bsz, S, G, N), Cm.reshape(Bsz, S, G, N))
        y = y + xs.reshape(Bsz, S, H, P) * p["D"][:, None]
        y = y.reshape(Bsz, S, di) * F.silu(z)
        return self.mm(self.rmsnorm(y, p["norm"]), p["out_proj"])

    @staticmethod
    def _segsum(x):
        """exp-ready segment sums: out[..., i, j] = sum x[j+1..i], -inf
        above the diagonal."""
        T = x.shape[-1]
        x = x[..., None].expand(*x.shape, T)
        low = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                    device=x.device), -1)
        s = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
        return s.masked_fill(~torch.tril(low | torch.eye(
            T, dtype=torch.bool, device=x.device)), float("-inf"))

    def ssd(self, x, dt, A, Bm, Cm):
        """The SSD scan, chunked (Dao and Gu, 2024, listing 1)."""
        Bsz, S, H, P = x.shape
        G = Bm.shape[2]
        Q = min(self.c["mamba_chunk_size"], S)
        nc = S // Q
        Bm = Bm.repeat_interleave(H // G, dim=2)
        Cm = Cm.repeat_interleave(H // G, dim=2)
        x = (x * dt[..., None]).reshape(Bsz, nc, Q, H, P)
        Ad = (A * dt).reshape(Bsz, nc, Q, H).permute(0, 3, 1, 2)  # b h c l
        Bm = Bm.reshape(Bsz, nc, Q, H, -1)
        Cm = Cm.reshape(Bsz, nc, Q, H, -1)
        Acum = torch.cumsum(Ad, dim=-1)
        L = torch.exp(self._segsum(Ad))                      # b h c l s
        y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp",
                              Cm, Bm, L, x)
        decay = torch.exp(Acum[..., -1:] - Acum)             # b h c l
        states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, decay, x)
        states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
        chunk_decay = torch.exp(self._segsum(
            F.pad(Acum[..., -1], (1, 0))))                   # b h z c
        states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay,
                              states)[:, :-1]
        y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, states,
                             torch.exp(Acum))
        return (y_diag + y_off).reshape(Bsz, S, H, P)

    def attention(self, x, p):
        c = self.c
        Bsz, S, D = x.shape
        H, Kh = c["num_attention_heads"], c["num_key_value_heads"]
        dh = D // H
        q = self.mm(x, p["wq"]["w"].reshape(D, H * dh)).reshape(
            Bsz, S, H, dh).transpose(1, 2)
        k = self.mm(x, p["wk"]["w"].reshape(D, Kh * dh)).reshape(
            Bsz, S, Kh, dh).transpose(1, 2).repeat_interleave(H // Kh, 1)
        v = self.mm(x, p["wv"]["w"].reshape(D, Kh * dh)).reshape(
            Bsz, S, Kh, dh).transpose(1, 2).repeat_interleave(H // Kh, 1)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        outs = []
        for q0 in range(0, S, QUERY_BLOCK):  # rows apart: the same softmax
            s = self.mm(q[:, :, q0:q0 + QUERY_BLOCK], k.transpose(-1, -2)) \
                * c["attention_multiplier"]
            a = torch.softmax(s.masked_fill(
                ~causal[q0:q0 + QUERY_BLOCK], float("-inf")), dim=-1)
            outs.append(self.mm(a, v))
        o = torch.cat(outs, 2).transpose(1, 2).reshape(Bsz, S, H * dh)
        return self.mm(o, p["wo"].reshape(H * dh, D))

    def moe(self, x, p):
        """The held experts' part of the routed experts, and the number
        of choices each held expert received."""
        c = self.c
        T = x.shape[0] * x.shape[1]
        xt = x.reshape(T, -1)
        logits = self.mm(xt, p["router"])
        top, idx = torch.topk(logits, c["num_experts_per_tok"], dim=-1)
        gates = torch.softmax(top, dim=-1)
        out = torch.zeros_like(xt)
        counts = []
        for e in range(c["num_local_experts"]):
            tok, slot = torch.nonzero(idx == c["expert_offset"] + e,
                                      as_tuple=True)
            counts.append(tok.numel())
            ye = self.swiglu(xt[tok], p["moe_wg"][e], p["moe_wi"][e],
                             p["moe_wo"][e])
            out = out.index_add(0, tok, ye * gates[tok, slot][:, None])
        return out.reshape(x.shape), counts

    # -- the model ----------------------------------------------------
    def layer(self, x, p, kind: str):
        m = self.c["residual_multiplier"]
        xn = self.rmsnorm(x, p["ln1"])
        h = self.mamba(xn, p) if kind == "mamba" else self.attention(xn, p)
        x = x + h * m
        xn = self.rmsnorm(x, p["ln2"])
        routed, _ = self.moe(xn, p)
        return x + (routed + self.swiglu(xn, p["shared_wg"], p["shared_wi"],
                                         p["shared_wo"])) * m

    def layers(self, params):
        """(kind, that layer's parameters) in the order the layers run."""
        seen = {"mamba": 0, "attention": 0}
        out = []
        for kind in self.c["layer_types"][:self.c["num_hidden_layers"]]:
            stack = params["mamba" if kind == "mamba" else "attn"]
            out.append((kind, _index(stack, seen[kind])))
            seen[kind] += 1
        return out

    def embed(self, params, tokens):
        return params["embed"][tokens] * self.c["embedding_multiplier"]

    def head_loss(self, params, x, labels, reduction="mean"):
        xn = self.rmsnorm(x, params["final_norm"])
        logits = self.mm(xn, params["embed"].t()) / self.c["logits_scaling"]
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), reduction=reduction)

    def loss(self, params, tokens, labels):
        x = self.embed(params, tokens)
        for kind, p in self.layers(params):
            x = self.layer(x, p, kind)
        return self.head_loss(params, x, labels)

    def loss_and_grads(self, params, tokens, labels):
        """The loss and the gradient of every leaf of ``params`` (float32
        copies), by autograd through the whole model."""
        live = _tree_map(lambda t: t.detach().to(F32).requires_grad_(True),
                         params)
        loss = self.loss(live, tokens, labels)
        leaves = _leaves(live)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _unflatten(live, list(grads))


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, flat):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], flat) for k in sorted(tree)}
    return flat.pop(0)


def hf_config(cfg) -> dict:
    """The Hugging Face keys of a program's ``ArchConfig`` (for tests)."""
    return {
        "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "mamba_n_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
        "mamba_d_head": cfg.ssm_headdim,
        "mamba_d_state": cfg.ssm_state,
        "mamba_n_groups": cfg.ssm_groups,
        "mamba_d_conv": cfg.ssm_conv,
        "mamba_chunk_size": 256,
        "num_experts_per_tok": cfg.moe_top_k,
        "num_local_experts": cfg.held_experts,
        "num_experts_total": cfg.num_experts,
        "expert_offset": cfg.expert_offset,
        "intermediate_size": cfg.d_ff_expert,
        "shared_intermediate_size": cfg.shared_d_ff,
        "rms_norm_eps": cfg.norm_eps,
        "attention_multiplier": cfg.attn_scale,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "logits_scaling": cfg.logits_scaling,
        "layer_types": list(cfg.layer_types),
        "num_hidden_layers": cfg.num_layers,
        "vocab_size": cfg.vocab_size,
    }
