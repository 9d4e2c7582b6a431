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

Optional exact second pass (two-pass WORp, Algorithm 2):

  init2(state)                         -> state2  priorities FROZEN from state
  update2(state2, state, keys, values) -> state2  exact-frequency replay
  merge2(a2, b2)                       -> state2
  sample2(state2, k)                   -> Sample

Registry: ``register(name)`` decorates a ``SamplerConfig -> SamplerSpec``
factory; ``make_sampler(name, cfg)`` is cached, so the same (name, cfg)
returns the same spec object.  Registered samplers (both bottom-k schemes
via ``cfg.scheme``):

  "onepass"  one-pass WORp (Sec. 5): CountSketch + candidate buffer,
             estimated frequencies; its pass-II hooks give exact
             Algorithm 2.
  "twopass"  streaming two-pass WORp: the pass-I sketch and the pass-II
             exact-frequency buffer in one state.  ``update`` keys the
             buffer by *online* priorities (the sketch so far), an
             approximation of Algorithm 2's frozen priorities; the pass-II
             hooks give the exact frozen-priority replay.
  "perfect"  oracle over an explicit (..., domain) frequency vector --
             ground truth for tests and benchmarks, same protocol.
  "tv"       Algorithm 1's low-variation-distance cascade (Sec. 6): r
             linear single-draw samplers + an rHH sketch.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from . import countsketch, hashing, perfect, transforms, tv_sampler, worp
from .device import resolve_device
from .perfect import Sample

_TV_FOLD = 0x9E3779B9  # "tv": seed = seed_sketch ^ (seed_transform * fold)


class SamplerConfig(NamedTuple):
    """Static sampler parameters, shared across the registry (hashable).

    Each sampler reads the fields it needs: the sketches rows/width/
    candidates, the two-pass buffer ``capacity``, the perfect oracle
    ``domain`` (its frequency vector's length), and the TV cascade
    ``num_samplers``."""

    rows: int = 7
    width: int = 2048
    candidates: int = 512
    capacity: int = 512
    p: float = 1.0
    scheme: str = transforms.PPSWOR
    domain: int = 4096        # "perfect": explicit frequency-vector length
    num_samplers: int = 8     # "tv": r single-draw samplers in the cascade


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


# ---------------------------------------------------------------------------
# one-pass WORp
# ---------------------------------------------------------------------------

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

    def init2(st):
        return worp.twopass_init(cfg.capacity, st.seed_transform)

    def update2(st2, st, keys, values):
        return worp.twopass_update(st2, st.sketch, keys, values)

    def sample2(st2, k):
        return worp.twopass_sample(st2, k, cfg.p, cfg.scheme)

    return SamplerSpec(name="onepass", cfg=cfg, init=init, update=update,
                       merge=worp.onepass_merge, sample=sample,
                       estimate=estimate, init2=init2, update2=update2,
                       merge2=worp.twopass_merge, sample2=sample2)


# ---------------------------------------------------------------------------
# two-pass WORp as a streaming spec
# ---------------------------------------------------------------------------

class TwoPassRunState(NamedTuple):
    """Pass-I sketch and pass-II exact-frequency buffer carried together,
    so that two-pass WORp fits the single-phase protocol (see the module
    docstring for the online-priority caveat)."""

    pass1: worp.OnePassState
    pass2: worp.TwoPassState


@register("twopass")
def _make_twopass(cfg: SamplerConfig) -> SamplerSpec:
    def init(seed_sketch, seed_transform, *, device=None):
        p1 = worp.onepass_init(cfg.rows, cfg.width, cfg.candidates,
                               seed_sketch, seed_transform, device=device)
        return TwoPassRunState(
            pass1=p1, pass2=worp.twopass_init(cfg.capacity, seed_transform,
                                              device=p1.sketch.seed.device))

    def update(st, keys, values):
        p1 = worp.onepass_update(st.pass1, keys, values, cfg.p, cfg.scheme)
        # online priorities: the buffer is keyed by the sketch SO FAR
        return TwoPassRunState(
            pass1=p1,
            pass2=worp.twopass_update(st.pass2, p1.sketch, keys, values))

    def merge(a, b):
        return TwoPassRunState(pass1=worp.onepass_merge(a.pass1, b.pass1),
                               pass2=worp.twopass_merge(a.pass2, b.pass2))

    def sample(st, k):
        return worp.twopass_sample(st.pass2, k, cfg.p, cfg.scheme)

    def estimate(st, keys):
        return countsketch.estimate(st.pass1.sketch, keys)

    def init2(st):
        return worp.twopass_init(cfg.capacity, st.pass1.seed_transform)

    def update2(st2, st, keys, values):
        return worp.twopass_update(st2, st.pass1.sketch, keys, values)

    def sample2(st2, k):
        return worp.twopass_sample(st2, k, cfg.p, cfg.scheme)

    return SamplerSpec(name="twopass", cfg=cfg, init=init, update=update,
                       merge=merge, sample=sample, estimate=estimate,
                       init2=init2, update2=update2,
                       merge2=worp.twopass_merge, sample2=sample2)


# ---------------------------------------------------------------------------
# perfect (oracle) sampler over an explicit frequency vector
# ---------------------------------------------------------------------------

class PerfectState(NamedTuple):
    """Explicit (..., domain) frequency vector -- what the sketches avoid,
    kept in the registry as protocol-shaped ground truth."""

    freqs: torch.Tensor           # (..., domain) float32 exact frequencies
    seed_transform: torch.Tensor  # (...) int64 uint32 seeds


@register("perfect")
def _make_perfect(cfg: SamplerConfig) -> SamplerSpec:
    def in_domain(keys):
        keys = keys.to(torch.int64)
        return (keys >= 0) & (keys < cfg.domain), keys.clamp(0,
                                                             cfg.domain - 1)

    def init(seed_sketch, seed_transform, *, device=None):
        del seed_sketch  # no sketch randomness: the oracle is exact
        if device is not None or not isinstance(seed_transform,
                                                torch.Tensor):
            device = resolve_device(device)
        seed = hashing.as_u32(seed_transform, device=device)
        return PerfectState(
            freqs=torch.zeros(seed.shape + (cfg.domain,),
                              dtype=torch.float32, device=seed.device),
            seed_transform=seed)

    def update(st, keys, values):
        ok, safe = in_domain(keys)
        add = torch.where(ok, values.to(torch.float32), 0.0)
        return PerfectState(freqs=st.freqs.clone().scatter_add_(-1, safe, add),
                            seed_transform=st.seed_transform)

    def merge(a, b):
        return PerfectState(freqs=a.freqs + b.freqs,
                            seed_transform=a.seed_transform)

    def sample(st, k):
        if k + 1 > cfg.domain:
            raise ValueError(
                f"perfect sample: k={k} needs k < domain={cfg.domain} "
                f"(the (k+1)-st transformed frequency is the threshold)")
        return perfect.ppswor_sample(st.freqs, k, cfg.p, st.seed_transform,
                                     cfg.scheme)

    def estimate(st, keys):
        ok, safe = in_domain(keys)
        t = transforms.transform_frequencies(
            safe, torch.gather(st.freqs, -1, safe), cfg.p,
            st.seed_transform[..., None], cfg.scheme)
        return torch.where(ok, t, 0.0)

    return SamplerSpec(name="perfect", cfg=cfg, init=init, update=update,
                       merge=merge, sample=sample, estimate=estimate)


# ---------------------------------------------------------------------------
# TV (Algorithm 1) cascade
# ---------------------------------------------------------------------------

@register("tv")
def _make_tv(cfg: SamplerConfig) -> SamplerSpec:
    def init(seed_sketch, seed_transform, *, device=None):
        # the cascade derives its whole seed bundle from one uint32; both
        # protocol seeds fold in, so shards of equal seed pairs merge
        if device is not None or not isinstance(seed_sketch, torch.Tensor):
            device = resolve_device(device)
        ss = hashing.as_u32(seed_sketch, device=device)
        st = hashing.as_u32(seed_transform, device=ss.device)
        return tv_sampler.init(
            cfg.num_samplers, cfg.rows, cfg.width, cfg.candidates,
            rhh_rows=cfg.rows, rhh_width=cfg.width,
            rhh_candidates=cfg.candidates,
            seed=ss ^ hashing.mul32(st, _TV_FOLD))

    def update(st, keys, values):
        return tv_sampler.update(st, keys, values, cfg.p, cfg.scheme)

    def sample(st, k):
        return tv_sampler.sample(st, k, cfg.p, cfg.scheme)

    def estimate(st, keys):
        return countsketch.estimate(st.rhh.sketch, keys)

    return SamplerSpec(name="tv", cfg=cfg, init=init, update=update,
                       merge=tv_sampler.merge, sample=sample,
                       estimate=estimate)

