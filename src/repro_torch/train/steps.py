"""Train / serve step functions (PyTorch port of ``repro.train.steps``).

``train_step``       : loss + gradients by autograd, then the AdamW update.
``serve_prefill``    : prompt processing -> logits + decode cache.
``serve_step``       : one decode token against a KV/state cache.
``make_compressed_train_step{,_tp}`` : data parallelism over a
                       ``torch.distributed`` group with the WORp-sketch
                       gradient all-reduce + error feedback (the paper's
                       application); the reference runs them under
                       ``shard_map`` over its dp mesh axes.
``make_compressed_train_step_engine`` : the same through the engine
                       compressor (one WOR sample a leaf, packed leaves,
                       one sketch launch) and an AdamW update in place.

Gradients come back in the parameters' dtype, as JAX's ``value_and_grad``
gives them; the AdamW update runs under ``torch.no_grad()``.  In the
compressed steps the batch is the step's GLOBAL batch and each rank takes
its own rows (rank r of D: ``[r B / D, (r + 1) B / D)``), as the
reference's ``batch_spec`` shards it; the loss is the ranks' mean
(``all_reduce(SUM)`` divided by the world size as a device tensor).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import pytree
from repro_torch.models import model as M
from repro_torch.optim import adamw, gradcomp
from repro_torch.trace import span


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def value_and_grad(params, batch, cfg: ArchConfig, wedge: bool = False):
    """(loss, gradient tree) of ``M.train_loss`` at ``params``: the loss
    detached, each gradient in its parameter's dtype (zeros for a leaf
    the loss does not reach)."""
    live = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    with torch.enable_grad():
        loss = M.train_loss(pytree.unflatten(params, live), batch, cfg,
                            wedge=wedge)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), pytree.unflatten(params, grads)


def train_step(state: TrainState, batch, cfg: ArchConfig, lr: float = 3e-4,
               wedge: bool = False):
    """Loss + grads + AdamW update."""
    loss, grads = value_and_grad(state.params, batch, cfg, wedge)
    with torch.no_grad():
        new_params, new_opt = adamw.update(state.params, grads, state.opt,
                                           lr=lr)
    return TrainState(params=new_params, opt=new_opt), {"loss": loss}


def serve_prefill(params, batch, cfg: ArchConfig, wedge: bool = False):
    with torch.no_grad():
        return M.prefill(params, batch, cfg, wedge=wedge)


def serve_step(params, batch, cfg: ArchConfig):
    with torch.no_grad():
        return M.decode_step(params, batch, cfg)


# ---------------------------------------------------------------------------
# WORp-compressed data parallelism
# ---------------------------------------------------------------------------

class CompressedTrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    error: Any  # worker-local error-feedback tree (f32)


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of every (B, ...) entry of the global batch:
    ``[rank B / world, (rank + 1) B / world)``."""
    out = {}
    for name, x in batch.items():
        B = x.shape[0]
        if B % world:
            raise ValueError(f"the batch's {name} has {B} rows, which do "
                             f"not split over {world} ranks")
        n = B // world
        out[name] = x[rank * n:(rank + 1) * n]
    return out


def _pmean(dist, x: torch.Tensor, group, world: int) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / torch.tensor(float(world), dtype=out.dtype,
                              device=out.device)


def make_compressed_train_step(cfg: ArchConfig, group, cc:
                               gradcomp.CompressorConfig, lr: float = 3e-4):
    """A DP train step with WORp gradient compression over ``group``
    (None: the default group; raises without an initialised one).

    Params/opt/error are the rank's own (the reference replicates them
    over the dp axes: pure DP); each rank takes its rows of the batch.
    The only gradient collective is the sketch ``all_reduce`` (+ the
    2k-float pass-II sum), instead of an N-float dense all-reduce."""
    dist, world = gradcomp._group(group, "make_compressed_train_step")
    rank = dist.get_rank(group)

    def step(state: CompressedTrainState, batch):
        loss, grads = value_and_grad(state.params,
                                     local_rows(batch, rank, world), cfg)
        loss = _pmean(dist, loss, group, world)
        with torch.no_grad():
            sparse, new_err, stats = gradcomp.tree_compress_step(
                grads, state.error, cc, group)
            new_params, new_opt = adamw.update(state.params, sparse,
                                               state.opt, lr=lr)
        return (CompressedTrainState(params=new_params, opt=new_opt,
                                     error=new_err),
                {"loss": loss, **stats})

    return step


def make_compressed_train_step_tp(cfg: ArchConfig, group, cc:
                                  gradcomp.CompressorConfig,
                                  lr: float = 3e-4):
    """The WORp-compressed DP step through the per-leaf (sharded) path,
    with no concatenated gradient vector.  Each rank's error tree carries
    a leading axis of 1 (its slice of the reference's error stacked on the
    dp axis); the metrics are the sharded path's (no ``tau``)."""
    dist, world = gradcomp._group(group, "make_compressed_train_step_tp")
    rank = dist.get_rank(group)

    def step(state: CompressedTrainState, batch):
        error = pytree.tree_map(lambda e: e[0], state.error)
        loss, grads = value_and_grad(state.params,
                                     local_rows(batch, rank, world), cfg)
        loss = _pmean(dist, loss, group, world)
        with torch.no_grad():
            sparse, new_err, stats = gradcomp.tree_compress_step_sharded(
                grads, error, cc, group)
            new_params, new_opt = adamw.update(state.params, sparse,
                                               state.opt, lr=lr)
        new_err = pytree.tree_map(lambda e: e[None], new_err)
        return (CompressedTrainState(params=new_params, opt=new_opt,
                                     error=new_err),
                {"loss": loss, **stats})

    return step


def make_compressed_train_step_engine(cfg: ArchConfig, group, cc:
                                      gradcomp.CompressorConfig,
                                      lr: float = 3e-4, k_per_leaf: int = 32,
                                      cand_per_leaf: int = 64,
                                      expose: bool = False):
    """The WORp-compressed DP step through the engine path
    (``gradcomp.tree_compress_step_engine``: a ``k_per_leaf`` WOR sample
    of every leaf, from ``cand_per_leaf`` candidates a leaf and rank),
    for models whose state fills the card: the leaves are packed with no
    padding, and AdamW updates the parameters and moments in place
    (``adamw.update_``; the state passed in is the state returned).  With
    ``expose`` the metrics also hold the step's gradient tree
    (``grads``) and sparse update (``update``)."""
    dist, world = gradcomp._group(group,
                                  "make_compressed_train_step_engine")
    rank = dist.get_rank(group)

    def step(state: CompressedTrainState, batch):
        with span("train.grad"):
            loss, grads = value_and_grad(state.params,
                                         local_rows(batch, rank, world), cfg)
        loss = _pmean(dist, loss, group, world)
        with torch.no_grad():
            sparse, new_err, stats = gradcomp.tree_compress_step_engine(
                grads, state.error, cc, group, k_per_leaf=k_per_leaf,
                cand_per_leaf=cand_per_leaf)
            with span("train.optim"):
                opt = adamw.update_(state.params, sparse, state.opt, lr=lr)
        metrics = {"loss": loss, **stats}
        if expose:
            metrics.update(grads=grads, update=sparse)
        return (CompressedTrainState(params=state.params, opt=opt,
                                     error=new_err), metrics)

    return step


__all__ = ["CompressedTrainState", "TrainState", "local_rows",
           "make_compressed_train_step", "make_compressed_train_step_engine",
           "make_compressed_train_step_tp",
           "serve_prefill", "serve_step", "train_step", "value_and_grad"]
