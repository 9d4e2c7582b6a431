"""PyTorch/CUDA port of the WORp sketching system (``repro`` is the JAX
reference).  Imports torch and numpy only."""
