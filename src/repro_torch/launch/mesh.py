"""Mesh descriptions for the H100 (the port's counterpart of
``repro.launch.mesh``).

A mesh here is a plain description, ``Mesh``: named axes with sizes
(``.shape``, the mapping ``repro_torch.distributed.sharding.resolve_pspec``
and ``shard_shape`` read).  The port runs a model on one card; the dry-run
(``repro_torch.launch.dryrun``) sizes the per-card shards of the layouts
below from these shapes alone, and an elastic restart
(``repro_torch.train.elastic.plan_remesh``) resolves a checkpoint's specs
against a mesh whose leaves live on its one ``device``.

Production layouts (``make_production_mesh``):

  card   (1, 1)      axes (data, model)        1 card
  node   (1, 8)      axes (data, model)        one 8-card NVLink node
  multi  (2, 16, 8)  axes (pod, data, model)   256 cards, 32 nodes

The ``model`` axis (tensor parallelism: heads, MLP, vocabulary, experts)
is never wider than the 8 cards of one NVLink domain: its collectives run
in every layer, on the activations, and only NVLink (450 GB/s a
direction) carries them at a rate near the card's; between nodes they
would cross the network.  ``data`` (FSDP and batch) spans the nodes of a
``pod``, and ``pod`` replicates across pods, as the reference's v5e pod
meshes ((16, 16) and (2, 16, 16)) do over their ICI and DCN.

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

LAYOUTS = {
    "card": ((1, 1), ("data", "model")),
    "node": ((1, 8), ("data", "model")),
    "multi": ((2, 16, 8), ("pod", "data", "model")),
}


@dataclass(frozen=True)
class Mesh:
    """Named axes: ``shape`` maps each axis to its size, in order;
    ``device`` is the one device a leaf placed on the mesh lives on (None
    for a layout only sized, never run)."""
    shape: Dict[str, int]
    device: Optional[torch.device] = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh_auto(shape, axes, device=None) -> Mesh:
    """A mesh of the given axis sizes and names."""
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh_auto: shape {tuple(shape)} and axes "
                         f"{tuple(axes)} differ in length")
    return Mesh(dict(zip(axes, (int(s) for s in shape))), device)


def make_production_mesh(layout: str = "card") -> Mesh:
    """One of ``LAYOUTS`` (module docstring), sized, not bound to devices."""
    if layout not in LAYOUTS:
        raise ValueError(f"make_production_mesh: unknown layout "
                         f"{layout!r}; known: {tuple(LAYOUTS)}")
    return make_mesh_auto(*LAYOUTS[layout])
