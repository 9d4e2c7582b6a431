"""Core WORp primitives in PyTorch: hashing, transform, CountSketch, one-pass
WORp and the sampler registry.  Functions take a leading batch axis where
the JAX package used ``vmap``."""
from . import (  # noqa: F401
    counters,
    countsketch,
    estimators,
    hashing,
    perfect,
    psi,
    sampler,
    transforms,
    tv_sampler,
    worp,
)
from .perfect import Sample  # noqa: F401
from .sampler import SamplerConfig, SamplerSpec, make_sampler  # noqa: F401
