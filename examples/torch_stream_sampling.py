"""Distributed stream sampling on the PyTorch port: merge WORp sketches
from independent shards.

    PYTHONPATH=src python examples/torch_stream_sampling.py [--device cpu]

The port's twin of ``examples/stream_sampling.py``: 4 data shards (e.g. 4
servers) each sketch their own slice of a token stream; the merged sketch
equals the sketch of the union -- the composability the paper's framework
guarantees, checked here against one sketcher fed every shard's tokens
(the tables within the float32 summing tolerance, the sample keys
identical).  Each batch goes in as +1 events through one launch of the
scatter kernel and the candidate refresh through one of the estimate
kernel (``FrequencySketcher.observe_signed(..., use_kernel=True)``; their
plain versions on the CPU).  Runs on the card unless ``--device`` says
otherwise.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import FrequencySketcher, ZipfStream


def observe(sk: FrequencySketcher, tokens) -> None:
    """Count each token once (+1 events), through the kernels."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    sk.observe_signed(toks, np.ones(toks.shape, np.float32), use_kernel=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    stream = ZipfStream(vocab_size=5_000, alpha=1.5, seed=42)
    shards = [FrequencySketcher(k=64, p=0.5, seed=99, device=dev)
              for _ in range(4)]
    union = FrequencySketcher(k=64, p=0.5, seed=99, device=dev)
    for step in range(args.steps):
        for shard_id, sk in enumerate(shards):
            batch = stream.batch_at(step, shard_id, 8, 128)
            observe(sk, batch)
            observe(union, batch)

    # composable merge: shard 0 absorbs the rest
    for other in shards[1:]:
        shards[0].merge_from(other)
    got, want = shards[0].state.sketch.table, union.state.sketch.table
    tables_close = bool(torch.allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max())))
    sample = shards[0].sample()
    keys = sample.keys.cpu().numpy()
    freqs = sample.freqs.cpu().numpy()
    same_keys = sorted(keys.tolist()) == sorted(
        union.sample().keys.cpu().tolist())
    print(f"merged sketch == sketch of the union: {tables_close and same_keys}"
          f" (tables allclose {tables_close}, sample keys equal {same_keys})")
    print("top tokens by nu^0.5 (WOR):")
    top = np.argsort(-np.abs(freqs), kind="stable")[:10]
    for i in top:
        print(f"  token {keys[i]:5d}  est freq {freqs[i]:8.1f}")

    # example-selection weights for a new batch (paper Sec. 1: LM example
    # weighting by powers of frequency)
    batch = stream.batch_at(100, 0, 2, 16)
    w = shards[0].selection_weights(batch).cpu().numpy()
    print("selection weights (frequent tokens down-weighted):")
    print(w.round(2))
    return {"device": str(dev), "merged_equals_union": tables_close
            and same_keys, "sample_keys": keys.tolist(),
            "sample_freqs": freqs.tolist(), "weights": w.tolist()}


if __name__ == "__main__":
    main()
