"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (plain
PyTorch).

The port's counterpart of ``repro.models.ssm``: within chunks the
recurrence in its dual quadratic-attention form (batched products), across
chunks a loop that carries the (B, H, N, P) state; decode is the O(1)
recurrent step.  Shapes: x (B, S, D); d_inner = expand*D; H = d_inner /
headdim heads of P = headdim channels; N = ssm_state; G = ssm_groups
(head h reads group h // (H / G), ``jnp.repeat``'s order).

Prefill takes no carried state (``mamba2_block``), its chunk is min(128,
S), and a prompt that is not a multiple of it raises, as in the reference.
The block runs in ``torch.use_deterministic_algorithms`` mode too (the
card's float ``cumsum`` and products take deterministic paths there,
``tests/test_torch_gpu.py``).  The softplus is
``F.softplus`` (the identity above 20, where ``jax.nn.softplus`` is
log(1 + e^x): they differ by under 2.1e-9 there).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard
from repro_torch.trace import span

from .layers import rmsnorm, silu


class SSMDims(NamedTuple):
    d_inner: int
    nheads: int
    headdim: int
    d_state: int
    ngroups: int
    d_conv: int

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.ngroups * self.d_state

    @property
    def in_proj_dim(self):
        # [z (gate), x, B, C, dt]
        return 2 * self.d_inner + 2 * self.ngroups * self.d_state + self.nheads


def dims_from_config(cfg) -> SSMDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    return SSMDims(d_inner=d_inner, nheads=d_inner // cfg.ssm_headdim,
                   headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                   ngroups=cfg.ssm_groups, d_conv=cfg.ssm_conv)


def _split_proj(zxbcdt, dims: SSMDims):
    d = dims.d_inner
    z = zxbcdt[..., :d]
    xBC = zxbcdt[..., d: d + dims.conv_dim]
    dt = zxbcdt[..., d + dims.conv_dim:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_state=None, bias=None):
    """Depthwise causal conv1d, width K.  xBC (B, S, C); conv_w (K, C);
    ``bias`` (C,) or None.

    Returns (silu(out), new_conv_state) where conv_state is the last K-1
    inputs."""
    K = conv_w.shape[0]
    if conv_state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:])
    else:
        pad = conv_state
    xp = torch.cat([pad, xBC], dim=1)  # (B, S+K-1, C)
    out = sum(xp[:, i: i + xBC.shape[1]] * conv_w[i] for i in range(K))
    if bias is not None:
        out = out + bias
    return silu(out), xp[:, -(K - 1):]


def ssd_chunked(x, dt, A, B_, C_, D_, dims: SSMDims, chunk: int = 128,
                initial_state=None):
    """Chunked SSD scan.

    x (B,S,H,P); dt (B,S,H) (softplus'd); A (H,) negative; B_/C_ (B,S,G,N).
    Returns y (B,S,H,P), final_state (B,H,N,P).
    """
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if S % chunk:
        raise ValueError(f"the sequence ({S}) is not a multiple of the "
                         f"chunk ({chunk})")
    nc = S // chunk
    rep = H // G
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = B_.reshape(Bsz, nc, chunk, G, N)
    Cc = C_.reshape(Bsz, nc, chunk, G, N)

    dA = dtc * A  # (B,nc,Q,H) negative increments
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    total = cum[:, :, -1]  # (B,nc,H)

    # ---- intra-chunk (dual quadratic form) ----
    # L[i,j] = exp(cum_i - cum_j) for i >= j else 0, the mask INSIDE the
    # exp: anti-causal exponents are positive and overflow, and a mask
    # after the exp has NaN gradients (0 * inf)
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    Lmat = torch.exp(torch.where(causal[None, None, :, :, None], ldiff,
                                 float("-inf")))
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc.to(f32), Bc.to(f32))
    scores = torch.repeat_interleave(scores, rep, dim=-1)  # (B,nc,Qi,Qj,H)
    M = scores * Lmat * dtc[:, :, None, :, :]  # weight dt_j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M, xc.to(f32))

    # ---- chunk boundary states ----
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    Brep = torch.repeat_interleave(Bc, rep, dim=3) if rep > 1 else Bc
    states = torch.einsum(
        "bcqhn,bcqhp->bchnp",
        (Brep * (dtc * decay_to_end)[..., None]).to(f32),
        xc.to(f32))  # (B,nc,H,N,P)

    # ---- inter-chunk linear scan: the state entering each chunk ----
    h = (initial_state.to(f32) if initial_state is not None
         else x.new_zeros((Bsz, H, N, P), dtype=f32))
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(total[:, c])[..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,N,P)

    # ---- inter-chunk contribution ----
    Crep = torch.repeat_interleave(Cc, rep, dim=3) if rep > 1 else Cc
    y_off = torch.einsum("bcqhn,bchnp->bcqhp",
                         (Crep * torch.exp(cum)[..., None]).to(f32),
                         prev_states)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    y = y + x.to(f32) * D_[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(x, dt, A, B_, C_, D_, state):
    """One recurrent step.  x (B,1,H,P), state (B,H,N,P) -> y, new_state.
    The B/C einsums sum over groups: right for one group only."""
    if B_.shape[2] != 1:
        raise ValueError(f"ssd_decode_step takes one group, got "
                         f"{B_.shape[2]}")
    f32 = torch.float32
    dA = torch.exp(dt[:, 0] * A)  # (B,H)
    Bx = torch.einsum("bgn,bhp->bhnp", B_[:, 0].to(f32),
                      (x[:, 0] * dt[:, 0, :, None]).to(f32))
    new_state = state * dA[..., None, None] + Bx
    y = torch.einsum("bgn,bhnp->bhp", C_[:, 0].to(f32), new_state)
    y = y + x[:, 0].to(f32) * D_[None, :, None]
    return y[:, None].to(x.dtype), new_state


def mamba2_block(x, lp, cfg, mode: str, state=None):
    """Full Mamba-2 block.  x (B,S,D).

    lp: in_proj (D, in_proj_dim), conv (K, conv_dim), A_log (H,), D (H,),
        dt_bias (H,), norm (d_inner,), out_proj (d_inner, D); conv_b
        (conv_dim,) where the config has a conv bias.  The gated norm takes
        the config's ``norm_eps``.
    state: None (train/prefill from scratch) or dict(conv, ssm) for decode.
    Returns (y, new_state).
    """
    f32 = torch.float32
    dims = dims_from_config(cfg)
    Bsz, S, _ = x.shape
    zxbcdt = torch.einsum("bsd,de->bse", x, lp["in_proj"])
    z, xBC, dt_raw = _split_proj(zxbcdt, dims)
    dt = F.softplus(dt_raw.to(f32) + lp["dt_bias"].to(f32))
    A = -torch.exp(lp["A_log"].to(f32))  # (H,)

    conv_state = state["conv"] if state is not None else None
    xBC, new_conv = _causal_conv(xBC, lp["conv"], conv_state,
                                 lp.get("conv_b"))
    gn = dims.ngroups * dims.d_state
    xs = xBC[..., : dims.d_inner].reshape(Bsz, S, dims.nheads, dims.headdim)
    B_ = xBC[..., dims.d_inner: dims.d_inner + gn].reshape(
        Bsz, S, dims.ngroups, dims.d_state)
    C_ = xBC[..., dims.d_inner + gn:].reshape(Bsz, S, dims.ngroups,
                                              dims.d_state)
    xs = shard(xs, "act_batch", "act_seq", "act_heads", None)

    if mode == "decode":
        y, new_ssm = ssd_decode_step(xs, dt, A, B_, C_, lp["D"].to(f32),
                                     state["ssm"])
    else:
        with span("ssd.scan"):
            y, new_ssm = ssd_chunked(xs, dt, A, B_, C_, lp["D"].to(f32),
                                     dims, chunk=min(128, S))
    y = y.reshape(Bsz, S, dims.d_inner)
    y = rmsnorm(y * silu(z), lp["norm"], cfg.norm_eps, zero_centered=False)
    out = torch.einsum("bse,ed->bsd", y, lp["out_proj"])
    return out, {"conv": new_conv, "ssm": new_ssm}
