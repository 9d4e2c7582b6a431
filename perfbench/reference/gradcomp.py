"""The reference of WORp gradient compression with one sample a leaf (the
per-layer engine step), on one rank, in plain PyTorch.

Each leaf b is a stream: its accumulated gradient a = g + e (e the error
feedback) is ppswor-transformed and sketched with the leaf's salt t_b =
seed + 0x9E3779B9 (b + 1) (mod 2**32), the sketch's hash seed t_b ^ 1; its
candidates are the ``cand_per_leaf`` coordinates of largest |a|; its sample
the ``k_per_leaf`` candidates of largest |R.Est|; the update carries a at
the sampled coordinates (exact values, "twopass", or Eq. 6's estimates,
"onepass"), and the new error is a with those coordinates zeroed.  Leaves
are taken in sorted order of their names.

The error feedback is stored in float32, so a is the float32 sum g + e (one
IEEE addition a coordinate, as exact as any other reading of it); the
candidates are its ``cand_per_leaf`` largest |a|, ties to the lower index,
and the sketch and estimates take it on in float64.  The candidates are a
hard cut: a float64 sum would move a coordinate across it on a near tie
that the stated arithmetic never has.
"""
from __future__ import annotations

import torch

from . import compare, hashing, sketch

SALT_STEP = 0x9E3779B9


def leaf_seeds(seed: int, b: int, device):
    t = (seed + SALT_STEP * (b + 1)) & hashing.MASK32
    return (torch.tensor([t ^ 1], dtype=torch.int64, device=device),
            torch.tensor([t], dtype=torch.int64, device=device))


def leaf_table(a: torch.Tensor, seeds, tseeds, cc, dtype) -> torch.Tensor:
    """(1, rows, width) sketch of one leaf's transformed coordinates."""
    n = a.shape[0]
    keys = torch.arange(n, dtype=torch.int64, device=a.device)[None]
    return sketch.scatter(keys, a[None], seeds, tseeds, cc.rows, cc.width,
                          cc.p, cc.scheme, dtype=dtype,
                          valid=torch.ones_like(keys, dtype=torch.bool))


def sizes_of(cc, k_per_leaf: int, cand_per_leaf: int, n_max: int):
    """(candidates a leaf, sample size a leaf) on one rank."""
    ncand = min(cand_per_leaf, n_max)
    return ncand, min(k_per_leaf, ncand - 1)


def comm_bytes(cc, leaves: int, k_leaf: int, ncand: int) -> float:
    """Bytes a worker puts on the wire a step, uncompressed (codec "none"):
    the L tables, the L x ncand candidate ids, and with exact values the
    L x k values."""
    if cc.codec != "none":
        raise ValueError(f"no byte count for codec {cc.codec!r}")
    floats = leaves * cc.rows * cc.width
    if cc.mode == "twopass":
        floats += leaves * k_leaf
    return 4.0 * (floats + leaves * ncand)


def accumulated(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """a = g + e of one leaf, flat, in float32."""
    return g.to(torch.float32).reshape(-1) + e.to(torch.float32).reshape(-1)


def candidates(a: torch.Tensor, ncand: int) -> torch.Tensor:
    """The ``ncand`` coordinates of largest |a|, ties to the lower index."""
    return torch.sort(a.abs(), descending=True, stable=True).indices[:ncand]


def _require(cc):
    if cc.estimator != "raw" or cc.mode not in ("twopass", "onepass"):
        raise ValueError(f"no reference for mode {cc.mode!r} with "
                         f"estimator {cc.estimator!r}")


def step(grads: dict, error: dict, cc, k_per_leaf: int, cand_per_leaf: int,
         dtype=torch.float64):
    """One compressed step computed by the reference in ``dtype``: (the
    sparse update tree, the new error tree, {"comm_bytes": ...})."""
    _require(cc)
    names = sorted(grads)
    n_max = max(grads[k].numel() for k in names)
    ncand, k_leaf = sizes_of(cc, k_per_leaf, cand_per_leaf, n_max)
    sparse, new_err = {}, {}
    for b, name in enumerate(names):
        g = grads[name]
        a = accumulated(g, error[name]).to(dtype)
        seeds, tseeds = leaf_seeds(cc.seed, b, g.device)
        table = leaf_table(a, seeds, tseeds, cc, dtype)
        cand = candidates(a, ncand)
        est = sketch.estimate(table, cand[None], seeds)[0]
        order = torch.sort(sketch.priority(est), descending=True,
                           stable=True).indices[:k_leaf]
        sel = cand[order]
        if cc.mode == "twopass":
            vals = a[sel]
        else:
            vals = est[order] * hashing.inverse_factor(
                sel, tseeds, cc.p, cc.scheme).to(dtype)
        sp = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
        sp[sel] = vals.float()
        sparse[name] = sp.reshape(g.shape)
        new_err[name] = torch.where(sp != 0, 0.0, a.float()).reshape(g.shape)
    stats = {"comm_bytes": torch.tensor(
        comm_bytes(cc, len(names), k_leaf, ncand), dtype=torch.float32)}
    return sparse, new_err, stats


def check(grads: dict, error: dict, sparse: dict, new_err: dict,
          comm: float, cc, k_per_leaf: int, cand_per_leaf: int) -> dict:
    """The numbers that judge one step of the program, from its inputs
    (the gradients, and the error it carried in) and its outputs:
    ``ids_gap`` (the sampled coordinates' rank gap by the reference's
    |R.Est|), ``cand_gap`` (how far a sampled coordinate's |a| lies below
    the leaf's candidates'), ``value_err`` (the update's values),
    ``error_err`` (the new error) and ``comm_bytes_err``."""
    _require(cc)
    names = sorted(grads)
    n_max = max(grads[k].numel() for k in names)
    ncand, k_leaf = sizes_of(cc, k_per_leaf, cand_per_leaf, n_max)
    out = {"ids_gap": 0.0, "cand_gap": 0.0, "value_err": 0.0,
           "error_err": 0.0}
    for b, name in enumerate(names):
        a = accumulated(grads[name], error[name]).to(torch.float64)
        seeds, tseeds = leaf_seeds(cc.seed, b, a.device)
        table = leaf_table(a, seeds, tseeds, cc, torch.float64)
        cand = candidates(a, ncand)
        ref_top = sketch.top_priorities(sketch.priority(
            sketch.estimate(table, cand[None], seeds)), k_leaf)
        sp = sparse[name].reshape(-1)
        ids = torch.nonzero(sp).flatten()
        if ids.numel() > k_leaf:
            out["ids_gap"] = float("inf")
            continue
        got = sketch.priority(sketch.estimate(table, ids[None], seeds))
        out["ids_gap"] = max(out["ids_gap"], compare.rank_gap(
            ref_top, got, compare.finite_scale(ref_top)))
        if ids.numel():
            floor = float(a[cand[-1]].abs())
            short = floor - float(a[ids].abs().min())
            out["cand_gap"] = max(out["cand_gap"],
                                  max(short, 0.0) / max(floor, 1e-300))
            if cc.mode == "twopass":
                want = a[ids]
            else:
                want = sketch.estimate(table, ids[None], seeds)[0] \
                    * hashing.inverse_factor(ids, tseeds, cc.p, cc.scheme)
            out["value_err"] = max(out["value_err"], compare.value_err(
                sp[ids][None], want[None], compare.finite_scale(want[None])))
        want_e = a.clone()
        want_e[ids] = 0.0
        out["error_err"] = max(out["error_err"], compare.value_err(
            new_err[name].reshape(1, -1), want_e[None],
            compare.finite_scale(a[None])))
    out["comm_bytes_err"] = abs(float(comm) - comm_bytes(
        cc, len(names), k_leaf, ncand))
    return out
