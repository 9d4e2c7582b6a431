"""Sharded prefetching ingestion pipeline on the PyTorch port: producers
-> batcher -> plane.

    PYTHONPATH=src python examples/torch_sharded_ingest.py [--device cpu]

The port's twin of ``examples/sharded_ingest.py``: splits one live
turnstile stream across 4 producer threads by per-key hash
(``ShardedSource``), packs the ragged microbatches into fixed-shape blocks
(``PackedBatcher``), and feeds a SketchEngine through bounded ring buffers
with backpressure (``PrefetchingFeeder``).  Shows both consumption modes:

  * fan-in: deterministic shard round-robin into ONE async plane --
    BITWISE equal to the synchronous plane fed the same stream;
  * per-shard: each producer feeds its own sub-plane of a PipelinePlane,
    collapsed through the sampler's composable merge at sampling time.

On the card every block is one launch of the scatter kernel; the example
runs in the deterministic mode (``torch.use_deterministic_algorithms``),
where fan-in == sync holds bit for bit there.  Runs on the card unless
``--device`` says otherwise.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.ingest_pipeline import PrefetchingFeeder, ShardedSource
from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.engine import EngineConfig, SketchEngine

B, SHARDS = 4, 4  # engine streams, producer shards
CFG = EngineConfig(num_streams=B, rows=5, width=512, candidates=64, p=1.0,
                   seed=7)


def feed(plane, dev, nsteps, pershard=False, **plane_opts):
    stream = TurnstileZipfStream(vocab_size=512, alpha=1.6, seed=3,
                                 delete_fraction=0.25)
    eng = SketchEngine(CFG, plane=plane, flush_elems=1,
                       plane_opts=plane_opts or None, device=dev)
    # one canonical event stream, hash-partitioned across SHARDS producers
    src = ShardedSource.from_turnstile(stream, n=96, num_shards=SHARDS,
                                       nsteps=nsteps)
    stats = PrefetchingFeeder(src, eng, block_elems=256, prefetch=2,
                              pershard=pershard).run()
    return eng, stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    engines = []
    try:
        sync, _ = feed("sparse", dev, args.steps)
        asyn, stats = feed("async", dev, args.steps)
        engines += [sync, asyn]
        same = torch.equal(sync.state.sketch.table, asyn.state.sketch.table)
        print(f"threaded fan-in into async plane bitwise == sync plane: "
              f"{same}")
        print(f"  {stats.shards} producers, {stats.events} events in "
              f"{stats.blocks} fixed-shape blocks of span {stats.span} "
              f"(pack efficiency {stats.pack_efficiency:.2f})")
        print(f"  producers blocked {stats.producer_wait_s * 1e3:.1f} ms "
              f"total (backpressure), consumer waited "
              f"{stats.pump_wait_s * 1e3:.1f} ms")

        pipe, _ = feed("pipeline", dev, args.steps, pershard=True,
                       shards=SHARDS)
        engines.append(pipe)
        close = torch.allclose(pipe.state.sketch.table,
                               sync.state.sketch.table, atol=1e-3)
        print(f"per-shard sub-planes collapse (merge) to the fan-in state: "
              f"{close}")

        s = pipe.sample(8)
        keys, freqs = s.keys.cpu().numpy(), s.freqs.cpu().numpy()
        print("per-request top tokens (WOR ell_1 over the sharded stream):")
        for b in range(B):
            pairs = [f"{int(t)}:{f:.0f}" for t, f in zip(keys[b], freqs[b])
                     if t >= 0]
            print(f"  req {b}: {' '.join(pairs)}")
    finally:
        for eng in engines:
            eng.plane.close()
        torch.use_deterministic_algorithms(was)
    return {"device": str(dev), "fan_in_equals_sync": same,
            "pershard_close": close, "events": stats.events,
            "table": sync.state.sketch.table.cpu().numpy(),
            "sample_keys": keys.tolist(), "sample_freqs": freqs.tolist()}


if __name__ == "__main__":
    main()
