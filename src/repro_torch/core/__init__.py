"""Core WORp primitives in PyTorch: hashing, transform, CountSketch, one-pass
WORp and the sampler registry.  Functions take a leading batch axis where
the JAX package used ``vmap``."""
