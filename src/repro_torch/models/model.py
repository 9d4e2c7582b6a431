"""Public model facade: parameters, caches, losses and small inputs
(PyTorch).

The port's counterpart of ``repro.models.model``.  ``input_specs`` and
``abstract_*`` give the dry-run's stand-ins as tensors on ``device="meta"``
(the reference's ``ShapeDtypeStruct``s), of each leaf's per-card shard
shape when a mesh is given.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd

from . import params as P
from . import transformer as T


def abstract_params(cfg: ArchConfig, mesh=None, dtype=torch.bfloat16):
    tree = T.param_tree(cfg)
    if mesh is None:
        return P.abstract(tree, dtype)
    return P.abstract_sharded(tree, mesh, dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None):
    return P.initialize(T.param_tree(cfg), generator, dtype, device)


def param_pspecs(cfg: ArchConfig, mesh, rules=None):
    return P.pspecs(T.param_tree(cfg), mesh, rules)


def param_count(cfg: ArchConfig) -> int:
    return P.count(T.param_tree(cfg))


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k of num_experts experts)."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    expert = 3 * cfg.d_model * cfg.d_ff_expert * cfg.num_layers
    return total - expert * (cfg.num_experts - cfg.moe_top_k)


def abstract_cache(cfg: ArchConfig, B: int, S: int, mesh=None,
                   dtype=torch.bfloat16):
    tree = T.cache_tree(cfg, B, S)
    if mesh is None:
        return P.abstract(tree, dtype)
    return P.abstract_sharded(tree, mesh, dtype)


def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16,
               device=None):
    """The decode cache for a max context of S tokens, zeros."""
    return P.initialize(T.cache_tree(cfg, B, S), None, dtype, device)


# ---------------------------------------------------------------------------
# losses / step fns
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over (B, S) labels vs (B, S, V) logits, in float32; the
    label logit by a one-hot multiply-sum, as the reference takes it."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    oh = F.one_hot(labels.to(torch.int64), lg.shape[-1]).to(torch.float32)
    picked = torch.sum(lg * oh, dim=-1)
    return torch.mean(lse - picked)


def train_loss(params, batch, cfg: ArchConfig, wedge: bool = False):
    logits = T.forward_train(params, batch, cfg, wedge=wedge)
    if cfg.family == "vlm":  # loss only over the text positions
        logits = logits[:, cfg.num_patches:]
    return cross_entropy(logits, batch["labels"])


def prefill(params, batch, cfg: ArchConfig, wedge: bool = False):
    return T.forward_prefill(params, batch, cfg, wedge=wedge)


def decode_step(params, batch, cfg: ArchConfig):
    return T.forward_decode(params, batch, cfg)


# ---------------------------------------------------------------------------
# inputs per (arch x shape)
# ---------------------------------------------------------------------------

_ACT_AXES = {"tokens": ("act_batch", "act_seq"),
             "frames": ("act_batch", "act_seq", "act_embed"),
             "patch_embeds": ("act_batch", None, "act_embed"),
             "labels": ("act_batch", "act_seq"),
             "token": ("act_batch", None)}


def _input_shapes(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, Any]:
    """The step's inputs of this cell: name -> (shape, kind), kind
    "tokens" or "embeds" ("cache" and "pos" for decode)."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out["frames"] = ((B, cfg.enc_context, cfg.d_model), "embeds")
            out["tokens"] = ((B, S), "tokens")
        elif cfg.family == "vlm":
            out["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model),
                                   "embeds")
            out["tokens"] = ((B, S - cfg.num_patches), "tokens")
        else:
            out["tokens"] = ((B, S), "tokens")
        if shape.kind == "train":
            lab_s = S if cfg.family != "vlm" else S - cfg.num_patches
            out["labels"] = ((B, lab_s), "tokens")
        return out
    out["token"] = ((B, 1), "tokens")
    out["pos"] = ((), "pos")
    out["cache"] = ((B, S), "cache")
    return out


def input_specs(cfg: ArchConfig, shape: ShapeCell, mesh=None,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of the step function of this
    cell (the reference's ``ShapeDtypeStruct``s), each of its per-card
    shard shape when ``mesh`` is given: token ids int32, embeddings in
    ``dtype``, decode's ``pos`` an int32 scalar and its cache
    ``abstract_cache``."""
    out: Dict[str, Any] = {}
    for name, (shp, kind) in _input_shapes(cfg, shape).items():
        if kind == "cache":
            out[name] = abstract_cache(cfg, *shp, mesh=mesh, dtype=dtype)
            continue
        if kind == "pos":
            out[name] = torch.empty((), dtype=torch.int32, device="meta")
            continue
        if mesh is not None:
            shp = shd.shard_shape(shp, _ACT_AXES[name], mesh)
        out[name] = torch.empty(
            shp, dtype=torch.int32 if kind == "tokens" else dtype,
            device="meta")
    return out


def concrete_inputs(cfg: ArchConfig, shape: ShapeCell,
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Small concrete inputs (for REDUCED configs in smoke tests): token
    ids uniform in [0, max(vocab - 1, 2)), embeddings N(0, 1) x 0.02 in
    ``dtype``, decode's ``pos`` min(7, S - 1) and a zero cache, drawn from
    ``generator`` (seed 0 on ``device`` by default)."""
    if generator is None:
        generator = torch.Generator(device or "cpu").manual_seed(0)
    device = device or generator.device
    out: Dict[str, Any] = {}
    for name, (shp, kind) in _input_shapes(cfg, shape).items():
        if kind == "tokens":
            out[name] = torch.randint(0, max(cfg.vocab_size - 1, 2), shp,
                                      generator=generator, device=device,
                                      dtype=torch.int32)
        elif kind == "embeds":
            out[name] = (torch.randn(shp, generator=generator, device=device,
                                     dtype=torch.float32).to(dtype) * 0.02)
        elif kind == "pos":
            out[name] = min(7, shape.seq_len - 1)
        else:
            out[name] = init_cache(cfg, *shp, dtype=dtype, device=device)
    return out
