"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
and the plain PyTorch versions they are held against (``ref``)."""
