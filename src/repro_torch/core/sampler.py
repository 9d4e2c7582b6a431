"""Unified Sampler protocol: every WOR ell_p sampler as one composable spec.

A WOR sampler is an (init, update, merge, sample, estimate) bundle over a
fixed-shape state of tensors.  The functions take a leading stream axis
natively, so the batched engine calls the spec directly:

  init(seed_sketch, seed_transform) -> state      seeds (...) uint32 values
  update(state, keys, values)      -> state       (..., n) element batch
  merge(a, b)                      -> state       state of the union
  sample(state, k)                 -> Sample
  estimate(state, keys)            -> tensor      transformed-domain nu*-hat

``init`` also takes a keyword ``device``: the state lives there, else on a
tensor seed's device, else on the card (raising without one).

``init2``/``update2``/``merge2``/``sample2`` (the exact second pass) are
None until the two-pass slice of the port lands.

Registry: ``register(name)`` decorates a ``SamplerConfig -> SamplerSpec``
factory; ``make_sampler(name, cfg)`` is cached, so the same (name, cfg)
returns the same spec object.  Registered so far: ``onepass``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from . import countsketch, transforms, worp
from .perfect import Sample


class SamplerConfig(NamedTuple):
    """Static sampler parameters, shared across the registry (hashable)."""

    rows: int = 7
    width: int = 2048
    candidates: int = 512
    p: float = 1.0
    scheme: str = transforms.PPSWOR


class SamplerSpec(NamedTuple):
    """Frozen (init, update, merge, sample, estimate) bundle."""

    name: str
    cfg: SamplerConfig
    init: Callable[[Any, Any], Any]
    update: Callable[[Any, torch.Tensor, torch.Tensor], Any]
    merge: Callable[[Any, Any], Any]
    sample: Callable[[Any, int], Sample]
    estimate: Callable[[Any, torch.Tensor], torch.Tensor]
    init2: Optional[Callable[[Any], Any]] = None
    update2: Optional[Callable[[Any, Any, torch.Tensor, torch.Tensor],
                               Any]] = None
    merge2: Optional[Callable[[Any, Any], Any]] = None
    sample2: Optional[Callable[[Any, int], Sample]] = None

    @property
    def two_phase(self) -> bool:
        """True when the spec offers an exact frozen-priority second pass."""
        return self.init2 is not None


_REGISTRY: Dict[str, Callable[[SamplerConfig], SamplerSpec]] = {}


def register(name: str):
    """Decorator: register a ``SamplerConfig -> SamplerSpec`` factory."""

    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def available() -> tuple:
    """Registered sampler names, sorted."""
    return tuple(sorted(_REGISTRY))


@functools.lru_cache(maxsize=None)
def make_sampler(name: str,
                 cfg: SamplerConfig = SamplerConfig()) -> SamplerSpec:
    """Build (and cache) the spec for ``name`` under ``cfg``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown sampler {name!r}; registered: {', '.join(available())}"
        ) from None
    return factory(cfg)


@register("onepass")
def _make_onepass(cfg: SamplerConfig) -> SamplerSpec:
    def init(seed_sketch, seed_transform, *, device=None):
        return worp.onepass_init(cfg.rows, cfg.width, cfg.candidates,
                                 seed_sketch, seed_transform, device=device)

    def update(st, keys, values):
        return worp.onepass_update(st, keys, values, cfg.p, cfg.scheme)

    def sample(st, k):
        return worp.onepass_sample(st, k, cfg.p, cfg.scheme)

    def estimate(st, keys):
        return countsketch.estimate(st.sketch, keys)

    return SamplerSpec(name="onepass", cfg=cfg, init=init, update=update,
                       merge=worp.onepass_merge, sample=sample,
                       estimate=estimate)
