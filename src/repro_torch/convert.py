"""Carry one-pass WORp state between the JAX package and the port.

Both functions speak numpy, so neither package imports the other: a JAX
``OnePassState`` (batched or not) passes through ``np.asarray`` of its
leaves into ``onepass_state_from_numpy``, and ``onepass_state_to_numpy``
gives arrays the JAX ``OnePassState`` takes back.  A state continued in
either package gives the same samples.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import countsketch, hashing, worp


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
    return worp.OnePassState(
        sketch=countsketch.CountSketch(
            table=torch.tensor(table, device=device),
            seed=hashing.as_u32(seed.astype(np.int64), device=device)),
        cand_keys=torch.tensor(cand_keys, device=device),
        seed_transform=hashing.as_u32(seed_transform.astype(np.int64),
                                      device=device))


def onepass_state_to_numpy(st: worp.OnePassState) -> tuple:
    """(table float32, seed uint32, cand_keys int32, seed_transform uint32)
    numpy arrays, in the order of the JAX state's leaves."""
    return (st.sketch.table.detach().cpu().numpy().astype(np.float32),
            st.sketch.seed.cpu().numpy().astype(np.uint32),
            st.cand_keys.cpu().numpy().astype(np.int32),
            st.seed_transform.cpu().numpy().astype(np.uint32))
