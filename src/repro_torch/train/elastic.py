"""Elastic scaling + straggler mitigation (PyTorch port of
``repro.train.elastic``).

  * ``StragglerWatchdog`` -- per-step wall-clock monitor with an EWMA
    baseline; flags steps slower than ``threshold`` x the baseline and
    invokes a callback (in production: checkpoint + reschedule the slow
    host).  Host-only, the reference's own.
  * ``plan_remesh`` -- the mesh of a (possibly different) device count at
    restart time, with the reference's axis names and sizes.  The port
    runs a model on one card, so the mesh is a description
    (``launch.mesh.Mesh``) that ``sharding.set_mesh``/``resolve_pspec``
    take: its ``.shape`` maps axis names to sizes, and every leaf lives on
    its one device.
  * ``reshard_tree`` -- resolve every leaf's spec against that mesh (a
    spec naming an absent axis, or one that does not divide its dimension,
    raises, as ``NamedSharding`` does), then place the leaf on the mesh's
    device: the identity placement on one card.

Checkpoints are stored unsharded (``train.checkpoint``), so any committed
checkpoint restores onto any such mesh.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import Mesh, make_mesh_auto


class StragglerWatchdog:
    """EWMA step-time monitor; flags outlier steps (straggler suspects)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.seen = 0
        self.flagged: list[tuple[int, float, float]] = []
        self._t0: Optional[float] = None

    def step_begin(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int):
        dt = time.monotonic() - self._t0
        self.seen += 1
        if self.ewma is None:
            self.ewma = dt
            return dt
        if self.seen > self.warmup and dt > self.threshold * self.ewma:
            self.flagged.append((step, dt, self.ewma))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
            # do NOT poison the baseline with the outlier
            return dt
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt


def plan_remesh(num_devices: int, model_parallel: int, pods: int = 1,
                device=None) -> Mesh:
    """The mesh for ``num_devices`` at restart time: ``("data", "model")``
    of (num_devices // model_parallel, model_parallel), or ``("pod",
    "data", "model")`` for ``pods > 1``, as the reference plans it; its
    leaves on ``device`` (the card unless the caller asks otherwise).
    Raises where the sizes do not multiply to ``num_devices``, as
    ``jax.make_mesh`` does."""
    per_pod = num_devices // pods
    data = per_pod // model_parallel
    if pods > 1:
        names, sizes = ("pod", "data", "model"), (pods, data, model_parallel)
    else:
        names, sizes = ("data", "model"), (data, model_parallel)
    if data < 1 or math.prod(sizes) != num_devices:
        raise ValueError(
            f"plan_remesh: {num_devices} devices do not split into "
            f"{dict(zip(names, sizes))}")
    return make_mesh_auto(sizes, names, resolve_device(device))


def _check_spec(shape, spec, mesh: Mesh, where: str) -> None:
    """Raise unless ``spec`` (None, or per dimension None / a mesh axis /
    a tuple of mesh axes) names axes of ``mesh``, each once, dividing its
    dimension."""
    if spec is None:
        return
    if len(spec) > len(shape):
        raise ValueError(f"reshard_tree {where}: spec {spec} has more "
                         f"entries than the leaf's {len(shape)} dimensions")
    used: set = set()
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        size = 1
        for ax in axes:
            if ax not in mesh.shape:
                raise ValueError(f"reshard_tree {where}: spec {spec} names "
                                 f"axis {ax!r}, absent from the mesh "
                                 f"{mesh.shape}")
            if ax in used:
                raise ValueError(f"reshard_tree {where}: spec {spec} uses "
                                 f"axis {ax!r} twice")
            used.add(ax)
            size *= mesh.shape[ax]
        if dim % size:
            raise ValueError(f"reshard_tree {where}: dimension {dim} does "
                             f"not divide by {size} ({axes})")


def reshard_tree(tree, mesh: Mesh, pspecs, _path: str = ""):
    """Every leaf of ``tree`` (a tensor or array) on ``mesh``'s device,
    its spec in ``pspecs`` (the same nested dicts) resolved against the
    mesh first (elastic restart step 2)."""
    if isinstance(tree, dict):
        return {k: reshard_tree(tree[k], mesh, pspecs[k], f"{_path}[{k!r}]")
                for k in sorted(tree)}
    _check_spec(tuple(np.shape(tree)), pspecs, mesh, _path or "root")
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    return convert.params_from_numpy(tree, mesh.device)


__all__ = ["StragglerWatchdog", "plan_remesh", "reshard_tree"]
