"""One-pass low-variation-distance WOR sampler (paper Sec. 6, Algorithm 1).

Structure: r independent single-draw ell_p samplers A^1..A^r (linear
sketches with fresh per-sampler randomness) + one rHH sketch R.  At
extraction the samplers are consumed in sequence; every fresh key Out_i
drawn feeds the update (Out_i, -R(Out_i)) to all later samplers, so
linearity subtracts what was already sampled, up to the rHH's estimation
error (Theorem F.1).

The single samplers are precision samplers in the Andoni-Krauthgamer-Onak
style: a CountSketch over x_j / u_j^{1/p} with per-sampler randomness, whose
arg max is (close to) an ell_p draw, as in the reference.

Batched layout, as the reference's vmapped state: for a batch shape
``(...)``, the cascade tables are ``(..., r, rows, width)``, their hash
seeds and transform seeds ``(..., r)``, the candidates ``(..., r, C)``, and
the rHH a one-pass state of batch ``(...)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import countsketch, hashing, transforms, worp
from .device import resolve_device
from .perfect import Sample

_EMPTY = -1
_NEG = float("-inf")
_SEED_STEP = 0x9E3779B9   # per-sampler seed increment
_SKETCH_SALT = 0xABCD1234  # cascade hash seeds = transform seeds ^ salt


class TVSamplerState(NamedTuple):
    sketches: countsketch.CountSketch  # table (..., r, rows, width)
    cand_keys: torch.Tensor            # (..., r, C) per-sampler candidates
    transform_seeds: torch.Tensor      # (..., r) int64 uint32 seeds
    rhh: worp.OnePassState             # the rHH sketch R (one-pass WORp)


def init(num_samplers: int, rows: int, width: int, candidates: int,
         rhh_rows: int, rhh_width: int, rhh_candidates: int, seed,
         device=None) -> TVSamplerState:
    """Empty cascade; the batch shape is the shape of ``seed`` (uint32
    values).  The whole seed bundle is uint32 arithmetic on ``seed``, bit
    for bit the reference's.  The state lives on ``device``, else on a
    tensor seed's device, else on the card."""
    if device is not None or not isinstance(seed, torch.Tensor):
        device = resolve_device(device)
    seed = hashing.as_u32(seed, device=device)
    steps = hashing.mul32(
        torch.arange(num_samplers, dtype=torch.int64, device=seed.device),
        _SEED_STEP)
    seeds = (steps + seed[..., None]) & hashing.MASK32
    return TVSamplerState(
        sketches=countsketch.init(rows, width, seeds ^ _SKETCH_SALT),
        cand_keys=torch.full(seeds.shape + (candidates,), _EMPTY,
                             dtype=torch.int32, device=seed.device),
        transform_seeds=seeds,
        rhh=worp.onepass_init(rhh_rows, rhh_width, rhh_candidates,
                              seed_sketch=(seed + 77) & hashing.MASK32,
                              seed_transform=(seed + 99) & hashing.MASK32))


def update(st: TVSamplerState, keys, values, p: float,
           scheme: str = transforms.PPSWOR) -> TVSamplerState:
    """Every cascade sampler and the rHH take the (..., n) batch."""
    keys = keys.to(torch.int32)
    values = values.to(torch.float32)
    r = st.transform_seeds.shape[-1]
    kr = keys[..., None, :].expand(keys.shape[:-1] + (r, keys.shape[-1]))
    tvals = transforms.transform_values(kr, values[..., None, :], p,
                                        st.transform_seeds[..., None], scheme)
    sk = countsketch.update(st.sketches, kr, tvals)
    return TVSamplerState(
        sketches=sk, cand_keys=worp.refresh_candidates(sk, st.cand_keys, kr),
        transform_seeds=st.transform_seeds,
        rhh=worp.onepass_update(st.rhh, keys, values, p, scheme))


def merge(a: TVSamplerState, b: TVSamplerState) -> TVSamplerState:
    sk = countsketch.merge(a.sketches, b.sketches)
    return TVSamplerState(
        sketches=sk,
        cand_keys=worp.refresh_candidates(sk, a.cand_keys, b.cand_keys),
        transform_seeds=a.transform_seeds,
        rhh=worp.onepass_merge(a.rhh, b.rhh))


def _subtract_from_later(table, seeds, tseeds, key, value, i: int, p: float,
                         scheme: str) -> None:
    """Feed (key, value) to the cascade samplers j > i, in place on
    ``table``; the sketches j <= i keep their cells untouched (an add of
    +0 would turn a -0 cell into +0)."""
    later = table[..., i + 1:, :, :]              # (..., r', rows, width)
    if later.shape[-3] == 0:
        return
    rows, width = later.shape[-2:]
    tval = transforms.transform_values(key[..., None], value[..., None], p,
                                       tseeds[..., i + 1:], scheme)
    # every (sketch, row) of the key at once: one hash of (..., r', rows)
    salt = hashing.row_salt(seeds[..., i + 1:, None],
                            torch.arange(rows, device=table.device))
    k = key[..., None, None]
    # one term a cell, so the in-place add is exact in any order
    later.scatter_add_(-1, hashing.bucket_hash(k, salt, width)[..., None],
                       (hashing.sign_hash(k, salt)
                        * tval[..., None])[..., None])


def _cascade(st: TVSamplerState, k: int, p: float, scheme: str, estimate):
    """Algorithm 1's extraction loop: the (..., k) keys (-1 where FAIL) and
    the rHH estimates of those keys."""
    r, C = st.cand_keys.shape[-2:]
    batch = st.transform_seeds.shape[:-1]
    dev = st.cand_keys.device
    table = st.sketches.table.clone()
    cands = st.cand_keys
    # R does not change during the loop and every draw is a candidate: one
    # read gives R's estimates of all r x C candidates
    rhh_est = estimate(st.rhh.sketch,
                       cands.reshape(batch + (r * C,))).reshape(cands.shape)
    selected = torch.full(batch + (k,), _EMPTY, dtype=torch.int32, device=dev)
    sel_est = torch.zeros(batch + (k,), dtype=torch.float32, device=dev)
    n_sel = torch.zeros(batch, dtype=torch.int64, device=dev)
    slots = torch.arange(k, device=dev)
    for i in range(r):
        ck = cands[..., i, :]
        est = estimate(countsketch.CountSketch(
            table=table[..., i, :, :], seed=st.sketches.seed[..., i]), ck)
        est = torch.where(ck == _EMPTY, _NEG, torch.abs(est))
        # the first maximum, a NaN above every number (jnp.argmax)
        idx = worp.top_k(est, 1)[1]
        out = torch.gather(ck, -1, idx)[..., 0]
        out_est = torch.gather(rhh_est[..., i, :], -1, idx)[..., 0]
        fresh = ((selected != out[..., None]).all(-1) & (n_sel < k)
                 & (out != _EMPTY))
        take = (slots == n_sel[..., None]) & fresh[..., None]
        selected = torch.where(take, out[..., None], selected)
        sel_est = torch.where(take, out_est[..., None], sel_est)
        est_freq = transforms.invert_frequency(out, out_est, p,
                                               st.rhh.seed_transform, scheme)
        _subtract_from_later(table, st.sketches.seed, st.transform_seeds,
                             out, torch.where(fresh, -est_freq, 0.0), i, p,
                             scheme)
        n_sel = n_sel + fresh.to(torch.int64)
    return selected, sel_est


def produce_sample(st: TVSamplerState, k: int, p: float,
                   scheme: str = transforms.PPSWOR,
                   estimate=countsketch.estimate) -> torch.Tensor:
    """Algorithm 1's extraction loop: (..., k) keys, -1 where it FAILs.
    ``estimate(sketch, keys)`` reads a batched sketch (the plain median by
    default; the engine passes the estimate kernel's)."""
    return _cascade(st, k, p, scheme, estimate)[0]


def sample(st: TVSamplerState, k: int, p: float,
           scheme: str = transforms.PPSWOR,
           estimate=countsketch.estimate) -> Sample:
    """The cascade's keys with frequencies from the rHH (Eq. 6).  No
    bottom-k threshold exists for the cascade: it is NaN, not a number that
    Horvitz-Thompson estimators would trust."""
    keys, est_t = _cascade(st, k, p, scheme, estimate)
    live = keys != _EMPTY
    safe = torch.where(live, keys, 0)
    freqs = transforms.invert_frequency(safe, est_t, p,
                                        st.rhh.seed_transform[..., None],
                                        scheme)
    return Sample(keys=keys, freqs=torch.where(live, freqs, 0.0),
                  threshold=torch.full(keys.shape[:-1], float("nan"),
                                       device=keys.device),
                  transformed=torch.where(live, est_t, 0.0))
