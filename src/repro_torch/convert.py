"""Carry sampler state between the JAX package and the port.

Every function speaks numpy, so neither package imports the other.  A JAX
state (batched or not) passes through ``np.asarray`` of its leaves, in
``jax.tree_util.tree_leaves`` order, into ``state_from_numpy``, and
``state_to_numpy`` gives the leaves in that order, which
``jax.tree_util.tree_unflatten`` turns back into the JAX state.  The port's
states are NamedTuples with the reference's fields, so the leaf orders
agree.  uint32 leaves (seeds) travel as uint32 and live in the port as
int64 tensors (``hashing.as_u32``).  A state continued in either package
gives the same samples.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import countsketch, hashing, tv_sampler, worp
from repro_torch.core.sampler import PerfectState, TwoPassRunState

# the nested state types of each carried state, field by field (None: a
# tensor leaf)
_FIELDS = {
    countsketch.CountSketch: (None, None),
    worp.OnePassState: (countsketch.CountSketch, None, None),
    worp.TwoPassState: (None, None, None, None),
    TwoPassRunState: (worp.OnePassState, worp.TwoPassState),
    PerfectState: (None, None),
    tv_sampler.TVSamplerState: (countsketch.CountSketch, None, None,
                                worp.OnePassState),
}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return hashing.as_u32(a.astype(np.int64), device=device)
    return torch.tensor(a, device=device)


def state_from_numpy(kind, leaves, device):
    """A port state of type ``kind`` (``worp.OnePassState``,
    ``worp.TwoPassState``, ``sampler.TwoPassRunState``,
    ``sampler.PerfectState``, ``tv_sampler.TVSamplerState`` or
    ``countsketch.CountSketch``) from its numpy leaves in order."""
    it = iter(leaves)

    def leaf():
        a = next(it, None)
        if a is None:
            raise ValueError(f"state_from_numpy: too few leaves for "
                             f"{kind.__name__}")
        return _leaf_from_numpy(a, device)

    def build(k):
        return k(*(build(f) if f is not None else leaf()
                   for f in _FIELDS[k]))

    st = build(kind)
    if next(it, None) is not None:
        raise ValueError(f"state_from_numpy: too many leaves for "
                         f"{kind.__name__}")
    return st


def state_to_numpy(st) -> list:
    """The numpy leaves of a port state, in the JAX state's leaf order;
    int64 seed tensors come back as uint32."""
    if isinstance(st, torch.Tensor):
        a = st.detach().cpu().numpy()
        return [a.astype(np.uint32) if a.dtype == np.int64 else a]
    return [leaf for field in st for leaf in state_to_numpy(field)]


def onepass_state_from_numpy(table, seed, cand_keys, seed_transform,
                             device) -> worp.OnePassState:
    """Port state from numpy arrays: table (..., rows, width) float32,
    seeds (...) uint32, cand_keys (..., C) int32."""
    table = np.asarray(table, np.float32)
    seed = np.asarray(seed, np.uint32)
    cand_keys = np.asarray(cand_keys, np.int32)
    seed_transform = np.asarray(seed_transform, np.uint32)
    if table.shape[:-2] != seed.shape or cand_keys.shape[:-1] != seed.shape \
            or seed_transform.shape != seed.shape:
        raise ValueError(
            f"onepass_state_from_numpy: batch shapes disagree: table "
            f"{table.shape}, seed {seed.shape}, cand_keys {cand_keys.shape}, "
            f"seed_transform {seed_transform.shape}")
    return state_from_numpy(worp.OnePassState,
                            (table, seed, cand_keys, seed_transform), device)


def onepass_state_to_numpy(st: worp.OnePassState) -> tuple:
    """(table float32, seed uint32, cand_keys int32, seed_transform uint32)
    numpy arrays, in the order of the JAX state's leaves."""
    return tuple(state_to_numpy(st))
