"""Parameter declaration: shapes + logical sharding axes + initializers.

The port's counterpart of ``repro.models.params``.  Each model declares a
nested dict of ``PD`` (param definitions).  From that one tree come
concrete initialized tensors (``initialize``, from a ``torch.Generator``)
and per-leaf specs through the logical-axis rules
(``repro_torch.distributed.sharding.resolve_pspec``).  Leaves are visited
in the reference's flatten order (dict keys sorted), so a tree of tensors
and the reference's tree of arrays line up leaf by leaf.  ``abstract``
and ``abstract_sharded`` give the dry-run's stand-ins: tensors on
``device="meta"`` (a shape and a dtype, no storage), whole or of each
leaf's per-card shard.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import sharding


class PD(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | ssm_a | dt_bias

    def __repr__(self):
        return f"PD{self.shape}@{self.axes}"


def tree_map_pd(fn, tree):
    """``fn`` of every PD leaf of a nested dict, keys visited sorted."""
    if isinstance(tree, PD):
        return fn(tree)
    return {k: tree_map_pd(fn, tree[k]) for k in sorted(tree)}


def leaves(tree) -> list:
    """The leaves of a nested dict (PDs or tensors), keys sorted: the
    reference's ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def abstract(tree, dtype=torch.bfloat16):
    """Meta tensors of each leaf's shape (no allocation) -- the dry-run
    path."""
    return tree_map_pd(
        lambda pd: torch.empty(pd.shape, dtype=dtype, device="meta"), tree)


def abstract_sharded(tree, mesh, dtype=torch.bfloat16, rules=None):
    """Meta tensors of each leaf's per-card shard shape on ``mesh``
    (``sharding.shard_shape``)."""
    return tree_map_pd(
        lambda pd: torch.empty(
            sharding.shard_shape(pd.shape, pd.axes, mesh, rules),
            dtype=dtype, device="meta"), tree)


def pspecs(tree, mesh, rules=None):
    return tree_map_pd(
        lambda pd: sharding.resolve_pspec(pd.shape, pd.axes, mesh, rules),
        tree)


def initialize(tree, generator: Optional[torch.Generator],
               dtype=torch.bfloat16, device=None):
    """Concrete tensors on ``device`` (the generator's device by default):
    the reference's inits (a normal scaled by 1/sqrt(fan_in), zeros, ones,
    ``ssm_a`` = log U[1, 16], ``dt_bias`` = log(expm1(U[1e-3, 1e-1]))),
    drawn in float32 from ``generator`` leaf by leaf in sorted-key order,
    then cast to ``dtype``.  ``jax.random`` cannot be reproduced, so the
    values are not the reference's; parity goes through the reference's
    own parameters (``convert.params_from_numpy``).  ``generator`` may be
    None for a tree of zeros and ones only (a cache)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"

    def draw(pd: PD, fn):
        if generator is None:
            raise ValueError(f"initialize: {pd!r} ({pd.init}) needs a "
                             f"generator")
        return fn(pd.shape, generator=generator, device=device,
                  dtype=torch.float32)

    def mk(pd: PD):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=device)
        if pd.init == "ssm_a":
            return torch.log(1.0 + 15.0 * draw(pd, torch.rand)).to(dtype)
        if pd.init == "dt_bias":
            u = 1e-3 + (1e-1 - 1e-3) * draw(pd, torch.rand)
            return torch.log(torch.expm1(u)).to(dtype)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        return (draw(pd, torch.randn) * scale).to(dtype)

    return tree_map_pd(mk, tree)


def count(tree) -> int:
    return int(sum(math.prod(pd.shape) for pd in leaves(tree)))
