"""Quickstart on the PyTorch port: WOR ell_p sampling of a skewed stream
with WORp.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's twin of ``examples/quickstart.py``: the same data, seeds and
claims (the exact two-pass sample equals perfect p-ppswor; the one-pass
sample's overlap with it; an HT estimate of ||nu||_1).  Runs on the card
unless ``--device`` says otherwise.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import estimators, perfect, worp
from repro_torch.core.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- a skewed dataset of (key, value) elements, presented in batches --
    rng = np.random.default_rng(0)
    n, k, p = args.n, args.k, 1.0
    freqs = (np.arange(1, n + 1) ** -1.2 * 5_000).astype(np.float32)
    freqs = freqs[rng.permutation(n)]
    batch = max(1, n // 8)

    # --- one-pass WORp: composable sketch, sample-sized memory -----------
    seed_transform = 1234
    state = worp.onepass_init(rows=5, width=31 * k, candidates=4 * k,
                              seed_sketch=7, seed_transform=seed_transform,
                              device=dev)
    keys = torch.arange(n, device=dev)
    vals = torch.as_tensor(freqs, device=dev)
    for lo in range(0, n, batch):  # stream in batches (order never matters)
        state = worp.onepass_update(state, keys[lo:lo + batch],
                                    vals[lo:lo + batch], p)
    sample = worp.onepass_sample(state, k, p)

    # --- two-pass WORp: exact p-ppswor sample -----------------------------
    t = worp.twopass_init(capacity=2 * (k + 1), seed_transform=seed_transform,
                          device=dev)
    for lo in range(0, n, batch):
        t = worp.twopass_update(t, state.sketch, keys[lo:lo + batch],
                                vals[lo:lo + batch])
    sample2 = worp.twopass_sample(t, k, p)

    oracle = perfect.ppswor_sample(vals, k, p, seed_transform)
    one = set(sample.keys.cpu().tolist())
    two = set(sample2.keys.cpu().tolist())
    perfect_keys = set(oracle.keys.cpu().tolist())
    out = {"device": str(dev), "two_pass_equals_perfect": two == perfect_keys,
           "one_pass_overlap": len(one & perfect_keys), "k": k,
           "one_pass_keys": sorted(one), "two_pass_keys": sorted(two)}
    print("two-pass == perfect p-ppswor:", out["two_pass_equals_perfect"])
    print("one-pass overlap with perfect:", out["one_pass_overlap"], "/", k)

    # --- estimate a statistic the full vector would give ------------------
    out["true_l1"] = float(np.abs(freqs).sum())
    out["est_l1"] = float(estimators.sum_statistic(sample2, p,
                                                   lambda w: torch.abs(w)))
    err = abs(out["est_l1"] - out["true_l1"]) / out["true_l1"]
    print(f"||nu||_1: true {out['true_l1']:.1f}  HT estimate "
          f"{out['est_l1']:.1f} ({err:.2%} err) from {k} samples")
    return out


if __name__ == "__main__":
    main()
