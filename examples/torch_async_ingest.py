"""Data-plane tour on the PyTorch port: double-buffered async ingest +
multi-worker aggregation.

    PYTHONPATH=src python examples/torch_async_ingest.py [--device cpu]

The port's twin of ``examples/async_ingest.py``: streams signed turnstile
microbatches (inserts + retractions) through the sync sparse plane and the
double-buffered async plane, shows their drained states are BIT-identical
(dispatch boundaries are FlushPolicy-side, never timing-side), then shards
the same traffic over 4 "serving workers" and aggregates the per-request
samples through the host-form butterfly merge -- equal to a single worker
that saw everything.  On the card each flush is one launch of the scatter
kernel and each refresh or sample one of the estimate kernel; float
atomics add in a varying order there, so the example runs in the
deterministic mode (``torch.use_deterministic_algorithms``), where the
scatter takes its fixed-order variant and async == sparse holds bit for
bit.  Runs on the card unless ``--device`` says otherwise.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TurnstileZipfStream
from repro_torch.distributed import sharding as shd
from repro_torch.engine import EngineConfig, FlushPolicy, SketchEngine

B = 4  # requests (engine streams)
CFG = EngineConfig(num_streams=B, rows=5, width=512, candidates=64, p=1.0,
                   seed=7)


def microbatches(nsteps=12, n=64):
    stream = TurnstileZipfStream(vocab_size=512, alpha=1.6, seed=3,
                                 delete_fraction=0.25)
    for t in range(nsteps):
        rows = [stream.sparse_batch_at(t, shard=b, n=n) for b in range(B)]
        yield (np.stack([k for k, _ in rows]).astype(np.int32),
               np.stack([v for _, v in rows]).astype(np.float32))


def run(plane, dev, nsteps):
    eng = SketchEngine(CFG, plane=plane, flush=FlushPolicy(max_elems=256),
                       device=dev)
    for keys, vals in microbatches(nsteps):
        eng.ingest(keys, vals)  # async: returns while dispatch is in flight
    eng.flush()                 # deterministic drain
    return eng


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    engines = []
    try:
        sync, asyn = run("sparse", dev, args.steps), run("async", dev,
                                                         args.steps)
        engines += [sync, asyn]
        same = torch.equal(sync.state.sketch.table, asyn.state.sketch.table)
        print(f"async drained state bitwise == sync sparse plane: {same}")

        s = asyn.sample(8)
        keys, freqs = s.keys.cpu().numpy(), s.freqs.cpu().numpy()
        print("per-request top tokens (WOR ell_1, turnstile stream with "
              "deletes):")
        for b in range(B):
            pairs = [f"{int(t)}:{f:.0f}" for t, f in zip(keys[b], freqs[b])
                     if t >= 0]
            print(f"  req {b}: {' '.join(pairs)}")

        # -- multi-worker serving shape: round-robin shard + butterfly ------
        workers = [SketchEngine(CFG, plane="async", device=dev)
                   for _ in range(4)]
        single = SketchEngine(CFG, device=dev)
        engines += workers + [single]
        for i, (k, v) in enumerate(microbatches(args.steps)):
            workers[i % 4].ingest(k, v)
            single.ingest(k, v)
        states = [w.flush().state for w in workers]
        merged = shd.butterfly_allmerge(states, None, workers[0].merge_fn)
        keys_eq = torch.equal(workers[0].sample_state(merged, 8).keys,
                              single.flush().sample(8).keys)
        print(f"4-worker butterfly aggregate == single-worker sample keys: "
              f"{keys_eq}")
    finally:
        for eng in engines:
            eng.plane.close()
        torch.use_deterministic_algorithms(was)
    return {"device": str(dev), "async_equals_sync": same,
            "aggregate_equals_single": keys_eq, "sample_keys": keys.tolist(),
            "sample_freqs": freqs.tolist()}


if __name__ == "__main__":
    main()
