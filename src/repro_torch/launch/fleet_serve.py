"""Serving-fleet launcher: N replica PROCESSES, chaos-ready (PyTorch port of
``repro.launch.fleet_serve``).

    PYTHONPATH=src python -m repro_torch.launch.fleet_serve --replicas 3 \
        --requests 4 --steps 24 --batch 8 --topk 6 [--device cpu]

N spawned replica processes each own a SketchEngine shard
(``repro_torch.distributed.fleet``), a health-aware router partitions
synthetic Zipf turnstile traffic sticky-by-key-hash, and the
checkpoint-file merge protocol collapses the replica shards through the
merge trees at sampling time.  Traffic is the paper's turnstile model
(``data.pipeline.TurnstileZipfStream``): every step inserts fresh Zipf
draws per request stream and retracts a slice of the previous step's.

Replicas and the coordinator run on the card unless ``--device cpu``.
Chaos knobs script a mid-stream fault into one replica (``--kill-after``,
``--hang-after``, ``--delay``): the router detects the failure (ack
timeout -> probe -> backoff), respawns the replica from its last published
checkpoint, and replays the journaled suffix.  ``--verify`` re-runs the
identical stream through the single-process ``fleet`` data plane and
asserts the aggregated samples match BITWISE; it runs the whole launch
under ``torch.use_deterministic_algorithms(True)`` (the replicas inherit
it), because on the card the sums are order-fixed, and so bitwise, only in
that mode.

The run ends with per-request top-K tokens plus one greppable summary row:

    fleet_serve_summary,replicas=...,restarts=...,p50_ms=...,p99_ms=...
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import sampler as core_sampler
from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.distributed import codecs as wire_codecs
from repro_torch.distributed import fleet as F
from repro_torch.engine import EngineConfig


def traffic(stream: TurnstileZipfStream, requests: int, steps: int,
            batch: int) -> list:
    """(B, n) signed microbatches: request b plays shard b of the turnstile
    Zipf stream (per-step inserts + previous-step retractions), stacked so
    every step is one routed microbatch across all request streams."""
    out = []
    for t in range(steps):
        ks, vs = zip(*(stream.sparse_batch_at(t, b, batch)
                       for b in range(requests)))
        out.append((np.stack(ks).astype(np.int32),
                    np.stack(vs).astype(np.float32)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2,
                    help="replica processes (power of two merges via the "
                         "host butterfly, anything else via the tree)")
    ap.add_argument("--requests", type=int, default=4,
                    help="request streams (engine num_streams)")
    ap.add_argument("--steps", type=int, default=24,
                    help="routed microbatches")
    ap.add_argument("--batch", type=int, default=8,
                    help="fresh Zipf insertions per request per step")
    ap.add_argument("--topk", type=int, default=6)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=1.3,
                    help="Zipf exponent of the synthetic traffic")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", default="onepass",
                    choices=core_sampler.available())
    ap.add_argument("--publish-every", type=int, default=4,
                    help="replica batches between checkpoint publishes "
                         "(the replay window after a crash)")
    ap.add_argument("--kill-replica", type=int, default=-1,
                    help="replica id to fault-inject (-1 = none)")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="kill the faulted replica after N ingests")
    ap.add_argument("--hang-after", type=int, default=0,
                    help="hang the faulted replica after N ingests")
    ap.add_argument("--delay", type=float, default=0.0,
                    help="injected per-ingest latency on the faulted replica")
    ap.add_argument("--ack-timeout", type=float, default=10.0)
    ap.add_argument("--verify", action="store_true",
                    help="assert bitwise parity of the aggregated sample "
                         "against the single-process fleet plane, in the "
                         "deterministic mode (holds at every codec: the "
                         "reference plane publishes through the same wire "
                         "image)")
    ap.add_argument("--codec", default="none",
                    choices=wire_codecs.available_codecs(),
                    help="wire codec replicas publish checkpoints through "
                         "(seed/key leaves stay lossless; 'none' keeps "
                         "the bitwise fp32 path)")
    ap.add_argument("--device", default="cuda",
                    help="where the replicas and the coordinator hold their "
                         "states (the card by default; 'cpu' runs the plain "
                         "PyTorch paths)")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.kill_replica >= args.replicas:
        ap.error("--kill-replica out of range")
    if args.verify:
        torch.use_deterministic_algorithms(True)

    ecfg = EngineConfig(
        num_streams=args.requests, rows=5,
        width=max(256, 31 * args.topk), candidates=4 * args.topk,
        capacity=4 * args.topk, p=args.p, seed=0x5EED ^ args.seed,
        sampler=args.sampler, domain=args.vocab,
        num_samplers=max(4, args.topk))
    fcfg = F.FleetConfig(engine=ecfg, replicas=args.replicas,
                         publish_every=args.publish_every,
                         ack_timeout=args.ack_timeout,
                         ping_timeout=min(5.0, args.ack_timeout),
                         codec=args.codec, device=args.device)
    faults = {}
    if args.kill_replica >= 0:
        faults[args.kill_replica] = F.FaultPlan(
            kill_after=args.kill_after or None,
            hang_after=args.hang_after or None,
            delay_s=args.delay)

    stream = TurnstileZipfStream(vocab_size=args.vocab, alpha=args.alpha,
                                 seed=args.seed)
    batches = traffic(stream, args.requests, args.steps, args.batch)

    t0 = time.perf_counter()
    with F.FleetCoordinator(fcfg, faults=faults) as co:
        t_up = time.perf_counter() - t0
        for keys, vals in batches:
            co.route(keys, vals)
        sample = co.sample(args.topk)
        stats = co.stats
    wall = time.perf_counter() - t0

    keys = sample.keys.cpu().numpy()
    freqs = sample.freqs.cpu().numpy()
    print(f"per-request top-{args.topk} tokens over {args.steps} turnstile "
          f"steps ({args.replicas} replica processes, {args.sampler}):")
    for b in range(args.requests):
        pairs = [f"{int(t)}:{f:.0f}" for t, f in zip(keys[b], freqs[b])
                 if t >= 0]
        print(f"  req {b}: {' '.join(pairs)}")

    if args.verify:
        ref = F.reference_sample(ecfg, batches, args.replicas, args.topk,
                                 codec=args.codec, device=args.device)
        ok = (np.array_equal(keys, ref.keys.cpu().numpy())
              and np.array_equal(freqs, ref.freqs.cpu().numpy()))
        if not ok:
            raise SystemExit("PARITY FAIL: fleet sample != single-process "
                             "fleet-plane reference")
        print(f"parity=bitwise (vs single-process fleet plane, "
              f"codec={args.codec})")

    p50 = stats.latency_percentile(50) * 1e3
    p99 = stats.latency_percentile(99) * 1e3
    print(f"fleet_serve_summary,replicas={args.replicas},"
          f"steps={args.steps},restarts={stats.restarts},"
          f"retries={stats.retries},probes={stats.probes},"
          f"startup_s={t_up:.1f},p50_ms={p50:.2f},p99_ms={p99:.2f},"
          f"events_per_s={stats.routed_events / max(wall - t_up, 1e-9):.0f},"
          f"codec={args.codec},pub_bytes={stats.published_bytes}")


if __name__ == "__main__":
    main()
