"""Serving launcher: prefill a batch of prompts, decode N tokens, with WORp
token analytics (PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \
        --reduced --device cpu --tokens 4 --batch 2 --prompt-len 16 \
        --worp-topk 5

The port's counterpart of ``repro.launch.serve``: the same flags, plus
``--device`` (the card unless the caller asks otherwise) and ``--seed``
(the weights and prompts; the reference's ``PRNGKey(0)`` cannot be
reproduced in torch, so the weights are random from this seed).  Decoding
is greedy: each step takes the first maximum of the logits over the padded
vocabulary, so an id may lie past ``vocab_size``, as in the reference.

With ``--worp-topk K`` every request (batch row) feeds its decoded token
ids into one stream of a batched ``SketchEngine`` (domain ``vocab_size``),
and the per-request top tokens print at the end.  The stream is sharded
round-robin over ``--workers`` engines: worker ``t % N`` ingests decode
step ``t``.  ``--worp-window W`` keeps only the last W steps, retracting
each aged-out step (value -1) through the worker that ingested it;
without a window the prompt is ingested too.  The workers' states reduce
through the merge trees at sampling time (``aggregate_worker_states``),
and the aggregated samples equal one engine that saw every step.
``--plane`` picks the data plane, ``--producers S`` wraps it in the
``pipeline`` plane of S sub-planes, and ``--codec`` names the wire codec of
the state crossings.  On the card a flush of token ids goes through the
scatter and estimate kernels of the ``sparse``, ``async`` and ``pipeline``
planes.

Every decoder family serves: dense, moe, ssm, hybrid and vlm (whose
random patch embeddings, from ``--seed``, come before the prompt, so
decoding starts at position prompt + ``num_patches``).  The enc-dec family
exits with the reference's message; drive it through ``models.model``'s
``prefill`` and ``decode_step``.  The caches grow by the decode budget as
the reference's do, but only the attention ``k``/``v`` leaves: the
reference pads any leaf whose axis 2 equals the prompt length, an SSM
state's head count or a recurrent conv state's width included (ROADMAP
Queue 3), so it crashes or misreads where the port serves.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ARCH_NAMES, get_config
from repro_torch.core import sampler as core_sampler
from repro_torch.core import worp
from repro_torch.core.device import resolve_device
from repro_torch.distributed import codecs as wire_codecs
from repro_torch.distributed import sharding as shd
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.engine.planes import available_planes
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def make_worker_engines(cfg: EngineConfig, workers: int, plane: str = "sparse",
                        flush_elems: int = 4096, plane_opts: dict = None,
                        device=None) -> list:
    """N mergeable engine shards: identical EngineConfig => identical
    per-stream hash/transform seeds (the ``merge_with`` contract), on
    ``device`` (the card unless the caller asks otherwise).  ``plane_opts``
    forwards plane-specific options."""
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    return [SketchEngine(cfg, plane=plane, flush_elems=flush_elems,
                         plane_opts=plane_opts, device=device)
            for _ in range(workers)]


def aggregate_worker_states(workers: list, codec: str = "none"):
    """Drain every worker's data plane and reduce the shard states to the
    union state through ``sharding.merge_states``.  ``codec`` names the
    wire codec each worker's state crosses to the aggregator (``none``
    keeps the bitwise path)."""
    if not workers:
        raise ValueError("aggregate_worker_states of no workers")
    ref = workers[0].cfg
    for i, w in enumerate(workers[1:], start=1):
        if w.cfg != ref:
            raise ValueError(
                f"worker {i} config differs from worker 0; shards must "
                f"share an EngineConfig to be mergeable")
    states = [w.flush().state for w in workers]
    return shd.merge_states(states, workers[0].merge_fn, codec=codec)


def sample_aggregated(workers: list, k: int, codec: str = "none"):
    """Per-request WOR samples over the UNION of all workers' ingested
    traffic (equals a single worker that saw the whole stream)."""
    merged = aggregate_worker_states(workers, codec=codec)
    return workers[0].sample_state(merged, k)


class Generation(NamedTuple):
    """``generate``'s result: the (B, n_tokens + 1) greedy ids (int32,
    host) and wall seconds: the prefill (to the first id on the host), the
    decode steps (the analytics' ingests left out), the analytics'
    ingests."""
    ids: np.ndarray
    prefill_s: float
    decode_s: float
    ingest_s: float


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 ids: the first maximum
    (``jnp.argmax``), NaN above every number."""
    return worp.top_k(logits, 1)[1][..., 0].to(torch.int32)


def grow_cache(cache, S: int, full: int, patches: int = 0):
    """Pad every attention cache (a ``k``/``v`` leaf (L, B, S or S +
    ``patches``, ...)) to ``full`` slots on axis 2, as the reference's
    ``grow`` pads a cache of the prompt's length: a local ring of
    ``local_window`` < S slots stays as it is, and one of S slots grows
    (the reference's ring, reproduced).  Recurrent and SSM state leaves
    are never padded (the reference's ``grow`` pads any leaf whose axis 2
    matches: ROADMAP Queue 3).  A leaf not padded is the input's own
    tensor, which decode then updates in place."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = grow_cache(v, S, full, patches)
        elif k in ("k", "v") and v.shape[2] in (S, S + patches):
            shape = list(v.shape)
            shape[2] = full - v.shape[2]
            out[k] = torch.cat([v, v.new_zeros(shape)], dim=2)
        else:
            out[k] = v
    return out


def generate(params, tokens: torch.Tensor, cfg, n_tokens: int, engines=(),
             window: int = 0, patch_embeds=None) -> Generation:
    """Prefill ``tokens`` (B, S) (after ``patch_embeds`` (B, P, D) for the
    vlm) and decode ``n_tokens`` greedy steps, as the reference's serving
    loop: with ``engines`` (one or more workers), the prompt is ingested
    into worker 0 unless ``window`` is set, and the first id and every
    decoded id, one step a call, into worker ``t % N``; with a window,
    step t - window is retracted (-1) through the worker that ingested it
    once step t is in.  The caches grow by the decode budget after the
    prefill.  Each step's ids come to the host, which waits for the card,
    so the times need no other synchronisation."""
    B, S = tokens.shape
    batch = {"tokens": tokens}
    P = 0
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
        P = patch_embeds.shape[1]
    nstep = 0
    held: list = []  # (worker, ids) still inside the window
    ingest_s = 0.0

    def ingest_step(ids: np.ndarray):
        nonlocal ingest_s
        t0 = time.perf_counter()
        widx = nstep % len(engines)
        engines[widx].ingest(ids, np.ones(ids.shape, np.float32))
        if window:
            held.append((widx, ids))
            if len(held) > window:
                oidx, old = held.pop(0)
                engines[oidx].ingest(old, -np.ones(old.shape, np.float32))
        ingest_s += time.perf_counter() - t0

    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = T.forward_prefill(params, batch, cfg)
        tok = greedy(logits[:, -1:])
        del logits
        cache = grow_cache(cache, S, S + P + n_tokens, P)
        ids = tok.cpu().numpy()
        prefill_s = time.perf_counter() - t0
        if engines:
            if not window:
                t1 = time.perf_counter()
                engines[0].ingest(tokens.cpu().numpy(),
                                  np.ones((B, S), np.float32))
                ingest_s += time.perf_counter() - t1
            ingest_step(ids)
            nstep += 1
        outs = [ids]
        before = ingest_s
        t0 = time.perf_counter()
        for i in range(n_tokens):
            lg, cache = T.forward_decode(
                params, {"token": tok, "pos": S + P + i, "cache": cache},
                cfg)
            tok = greedy(lg)
            ids = tok.cpu().numpy()
            outs.append(ids)
            if engines:
                ingest_step(ids)
                nstep += 1
        decode_s = time.perf_counter() - t0 - (ingest_s - before)
    return Generation(np.concatenate(outs, axis=1), prefill_s, decode_s,
                      ingest_s)


class Served(NamedTuple):
    """``main``'s result: the generation, the aggregated sample (None
    without ``--worp-topk``), the seconds its merge and draw took, and the
    engines (their planes closed)."""
    gen: Generation
    sample: object
    sample_s: float
    engines: list


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--worp-topk", type=int, default=0,
                    help="track per-request token streams in a batched "
                         "SketchEngine and report the top-K WOR sample")
    ap.add_argument("--worp-p", type=float, default=1.0)
    ap.add_argument("--worp-window", type=int, default=0,
                    help="sliding window: only the last W decode steps "
                         "count; older ones are retracted (0 = unbounded, "
                         "prompt included)")
    ap.add_argument("--sampler", default="onepass",
                    choices=core_sampler.available(),
                    help="registered sampler backing the token analytics")
    ap.add_argument("--plane", default="sparse", choices=available_planes(),
                    help="data plane of the analytics ingest")
    ap.add_argument("--workers", type=int, default=1,
                    help="serving replicas: the decode stream shards "
                         "round-robin across N engines, aggregated through "
                         "the merge trees at reporting time")
    ap.add_argument("--producers", type=int, default=1,
                    help="S > 1 wraps --plane in the 'pipeline' plane of S "
                         "sub-planes")
    ap.add_argument("--codec", default="none",
                    choices=wire_codecs.available_codecs(),
                    help="wire codec of the analytics state crossings")
    ap.add_argument("--device", default=None,
                    help="where the model and the analytics run (default: "
                         "the card; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (and, plus 1, of the "
                         "prompts)")
    return ap


def make_prompt(cfg, args, dev):
    """The CLI's random prompt (``--seed`` + 1) and, for the vlm, patch
    embeddings (N(0, 1) in bfloat16 x 0.02, ``--seed`` + 2; else None), on
    ``dev``."""
    tokens = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=torch.int32,
        device=dev, generator=torch.Generator(dev).manual_seed(args.seed + 1))
    patch_embeds = None
    if cfg.family == "vlm":
        patch_embeds = torch.randn(
            (args.batch, cfg.num_patches, cfg.d_model), dtype=torch.float32,
            device=dev, generator=torch.Generator(dev).manual_seed(
                args.seed + 2)).to(torch.bfloat16) * 0.02
    return tokens, patch_embeds


def main(argv=None) -> Served:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.worp_topk < 0:
        ap.error("--worp-topk must be >= 0")
    if args.worp_topk and args.worp_p <= 0:
        ap.error("--worp-p must be > 0 (samples by |freq|^p)")
    if args.worp_window < 0:
        ap.error("--worp-window must be >= 0")
    if args.workers < 1:
        ap.error("--workers must be >= 1")
    if args.producers < 1:
        ap.error("--producers must be >= 1")
    if args.producers > 1 and args.plane == "pipeline":
        ap.error("--producers already wraps --plane in the pipeline plane; "
                 "pick the SUB-plane (sparse/async/dense) with --plane")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise SystemExit("use the enc-dec driver in examples/ for seamless")
    dev = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           device=dev)
    tokens, patch_embeds = make_prompt(cfg, args, dev)
    B = args.batch
    engines: list = []
    if args.worp_topk:
        ecfg = EngineConfig(
            num_streams=B, rows=5, width=max(256, 31 * args.worp_topk),
            candidates=4 * args.worp_topk, p=args.worp_p, seed=0x5EED,
            sampler=args.sampler, domain=cfg.vocab_size,
            num_samplers=max(4, args.worp_topk))
        plane, plane_opts = args.plane, None
        if args.producers > 1:
            plane = "pipeline"
            plane_opts = {"shards": args.producers, "subplane": args.plane,
                          "codec": args.codec}
        engines = make_worker_engines(ecfg, args.workers, plane=plane,
                                      plane_opts=plane_opts, device=dev)
    try:
        gen = generate(params, tokens, cfg, args.tokens, engines,
                       args.worp_window, patch_embeds)
        print("generated ids:")
        for row in gen.ids:
            print(" ", row.tolist())
        sample, sample_s = None, 0.0
        if engines:
            t0 = time.perf_counter()
            sample = sample_aggregated(engines, args.worp_topk,
                                       codec=args.codec)
            keys = sample.keys.cpu().numpy()
            freqs = sample.freqs.cpu().numpy()
            sample_s = time.perf_counter() - t0
            scope = (f"last {args.worp_window} decode steps"
                     if args.worp_window else "prompt + decode")
            wtag = f", {args.workers} workers" if args.workers > 1 else ""
            print(f"per-request top-{args.worp_topk} tokens over {scope} "
                  f"(WOR ell_{args.worp_p} sample{wtag}):")
            for b in range(B):
                pairs = [f"{int(t)}:{f:.0f}"
                         for t, f in zip(keys[b], freqs[b]) if t >= 0]
                print(f"  req {b}: {' '.join(pairs)}")
    finally:
        for eng in engines:
            eng.plane.close()
    return Served(gen, sample, sample_s, engines)


if __name__ == "__main__":
    main()
