"""Training loop driver: steps, checkpoint/restart, straggler watchdog
(PyTorch port of ``repro.train.loop``).

``analytics_sampler`` turns on stream analytics over the training tokens:
the batch tokens feed a one-stream ``SketchEngine`` backed by any
registered sampler (onepass / twopass / perfect / tv), and the final
metrics include the top-token WOR sample (which tokens dominate the corpus
the model is seeing) at sketch cost, not vocabulary cost.
``analytics_plane`` picks the engine's data plane; the default ``"async"``
dispatches the scatter on a worker thread, drained at the final
``sample``.  ``analytics_producers`` > 1 shards the token feed per key
across S producer sub-planes (the ``pipeline`` plane), collapsed through
the sampler's merge at sampling time.  On the card a flush goes through
the scatter kernel and a refresh or the sample through the estimate
kernel.

The port's additions: ``group`` (the reference's ``mesh``) is the
``torch.distributed`` group of a compressed run (None: the default group;
a compressed run raises without an initialised one), and ``device``
(the card unless the caller asks otherwise).  The parameters are random
from ``seed`` (a ``torch.Generator``: ``jax.random`` cannot be
reproduced), the data the reference's own ``ZipfStream``.  In a group of
several ranks, rank 0 alone writes checkpoints (the state the reference's
single controller saves) and every rank restores them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import ZipfStream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.models import model as M
from repro_torch.optim import adamw, gradcomp
from repro_torch.train import checkpoint, steps
from repro_torch.train.elastic import StragglerWatchdog


def analytics_engine(cfg: ArchConfig, sampler: str, topk: int, plane: str,
                     producers: int, seed: int, device) -> SketchEngine:
    """The loop's token-analytics engine: one stream over the whole token
    stream, the reference's configuration; ``producers`` > 1 wraps
    ``plane`` in the ``pipeline`` plane of that many shards."""
    plane_opts = None
    if producers > 1:
        plane, plane_opts = "pipeline", {"shards": producers,
                                         "subplane": plane}
    return SketchEngine(EngineConfig(
        num_streams=1, rows=5, width=max(256, 31 * topk),
        candidates=4 * topk, capacity=4 * topk, seed=seed ^ 0x70CEB5,
        sampler=sampler, domain=cfg.vocab_size, num_samplers=max(4, topk)),
        plane=plane, plane_opts=plane_opts, device=device)


def run_training(
    cfg: ArchConfig,
    num_steps: int,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    compressed: bool = False,
    cc: Optional[gradcomp.CompressorConfig] = None,
    compressor: str = "flat",
    group=None,
    log_every: int = 10,
    seed: int = 0,
    print_fn: Callable[[str], None] = print,
    analytics_sampler: Optional[str] = None,
    analytics_topk: int = 16,
    analytics_plane: str = "async",
    analytics_producers: int = 1,
    device=None,
) -> Dict[str, Any]:
    """Train ``cfg`` on the synthetic Zipf stream.  Returns final
    metrics: ``final_loss``, ``losses``, ``stragglers``, ``state`` and,
    with analytics, ``top_tokens``."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                           device=dev)
    opt = adamw.init(params)
    stream = ZipfStream(vocab_size=cfg.vocab_size, alpha=1.2, seed=seed)
    start_step = 0
    dist, world, rank = None, 1, 0

    if compressed:
        cc = cc or gradcomp.CompressorConfig()
        dist, world = gradcomp._group(group, "run_training(compressed=True)")
        rank = dist.get_rank(group)
        state = steps.CompressedTrainState(
            params=params, opt=opt, error=gradcomp.init_error(params))
        makers = {"flat": steps.make_compressed_train_step,
                  "engine": steps.make_compressed_train_step_engine}
        if compressor not in makers:
            raise ValueError(f"compressor {compressor!r}: one of "
                             f"{sorted(makers)}")
        step_fn = makers[compressor](cfg, group, cc, lr=lr)
    else:
        state = steps.TrainState(params=params, opt=opt)

        def step_fn(s, b):
            return steps.train_step(s, b, cfg, lr=lr)
    del params, opt

    def barrier():
        if world > 1:
            dist.barrier(group=group)

    writer = rank == 0
    if ckpt_dir:
        if writer:
            checkpoint.gc_tmp(ckpt_dir)
        barrier()
        restored, rstep = checkpoint.restore_latest(ckpt_dir, state, dev)
        if restored is not None:
            state, start_step = restored, rstep + 1
            print_fn(f"[ckpt] resumed from step {rstep}")

    if analytics_producers < 1:
        raise ValueError(f"analytics_producers must be >= 1, got "
                         f"{analytics_producers}")
    analytics = None
    if analytics_sampler is not None:
        analytics = analytics_engine(cfg, analytics_sampler, analytics_topk,
                                     analytics_plane, analytics_producers,
                                     seed, dev)

    def save(step):
        if writer:
            checkpoint.save(ckpt_dir, step, state)
        barrier()

    watchdog = StragglerWatchdog(threshold=3.0)
    losses = []
    try:
        for step in range(start_step, num_steps):
            b = stream.lm_batch(step, shard=0, batch=batch, seq=seq,
                                device=dev)
            watchdog.step_begin()
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])
            watchdog.step_end(step)
            losses.append(loss)
            if analytics is not None:
                # per-step token batches buffer host-side and flush through
                # one batched scatter launch (the final sample() flushes any
                # tail); one device-to-host copy a step
                toks = b["tokens"].cpu().numpy().astype(np.int32).reshape(
                    1, -1)
                analytics.ingest(toks, np.ones_like(toks, np.float32))
            if step % log_every == 0:
                print_fn(f"step {step:5d}  loss {loss:.4f}")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save(step)
        if ckpt_dir:
            save(num_steps - 1)
        out = {"final_loss": losses[-1] if losses else float("nan"),
               "losses": losses, "stragglers": watchdog.flagged,
               "state": state}
        if analytics is not None:
            s = analytics.sample(analytics_topk)
            keys = s.keys.cpu().numpy()[0]
            freqs = s.freqs.cpu().numpy()[0]
            out["top_tokens"] = [(int(t), float(f))
                                 for t, f in zip(keys, freqs) if t >= 0]
            print_fn(f"[analytics/{analytics_sampler}] top-{analytics_topk} "
                     "tokens (WOR sample): "
                     + " ".join(f"{t}:{f:.0f}" for t, f in out["top_tokens"]))
    finally:
        if analytics is not None:
            analytics.plane.close()
    return out


__all__ = ["analytics_engine", "run_training"]
