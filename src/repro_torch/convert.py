"""Carry sampler state between the JAX package and the port.

Every function speaks numpy, so neither package imports the other.  A JAX
state (batched or not) passes through ``np.asarray`` of its leaves, in
``jax.tree_util.tree_leaves`` order, into ``state_from_numpy``, and
``state_to_numpy`` gives the leaves in that order, which
``jax.tree_util.tree_unflatten`` turns back into the JAX state.  The port's
states are NamedTuples with the reference's fields, so the leaf orders
agree.  uint32 leaves (seeds) travel as uint32 and live in the port as
int64 tensors (``hashing.as_u32``).  A state continued in either package
gives the same samples.  ``tree_to_numpy``/``tree_from_numpy`` carry dicts
of states (``{"state": ..., "pass2": ...}``, a checkpoint's tree), with
their keys in sorted order as JAX flattens them.  ``params_from_numpy``/
``params_to_numpy`` carry a model's parameter (or cache) tree, nested dicts
of arrays in the reference's ``param_tree`` keys.
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


def _num_leaves(kinds) -> int:
    if isinstance(kinds, dict):
        return sum(_num_leaves(k) for k in kinds.values())
    return sum(1 if f is None else _num_leaves(f) for f in _FIELDS[kinds])


def tree_to_numpy(tree) -> list:
    """The numpy leaves of a port state or a dict of them, in the JAX
    tree's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [a for key in sorted(tree) for a in tree_to_numpy(tree[key])]
    return state_to_numpy(tree)


def tree_from_numpy(kinds, leaves, device):
    """A port state, or a dict of them, from numpy leaves in the JAX tree's
    order: ``kinds`` is a state type (as for ``state_from_numpy``) or a
    dict of them, e.g. ``{"state": worp.OnePassState, "pass2":
    worp.TwoPassState}``."""
    leaves = list(leaves)
    if not isinstance(kinds, dict):
        return state_from_numpy(kinds, leaves, device)
    out, i = {}, 0
    for key in sorted(kinds):
        n = _num_leaves(kinds[key])
        out[key] = tree_from_numpy(kinds[key], leaves[i:i + n], device)
        i += n
    if i != len(leaves):
        raise ValueError(f"tree_from_numpy: {len(leaves)} leaves for a tree "
                         f"of {i}")
    return out


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


def params_from_numpy(tree, device, dtype=None):
    """A model tree of tensors on ``device`` from nested dicts of arrays
    (a JAX tree passes through ``np.asarray`` of its leaves): each leaf
    copied (``torch.tensor``), cast to ``dtype`` when given.  bfloat16
    arrays (``ml_dtypes``) cross as float32 first, which is exact."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in
                tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    else:
        t = torch.tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def params_to_numpy(tree):
    """Nested dicts of numpy arrays from a model tree of tensors; bfloat16
    leaves come back as float32 (numpy has no bfloat16), exactly."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()
