"""Standalone p-ppswor transform: the wrapper of ``csrc/ppswor_transform.cu``.

``ppswor_transform`` returns ``values * Exp1(hash(key, seed))^(-1/p)`` in
the values' type (float32 or bfloat16).  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor takes the plain version in
``ref``.  ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing

from . import build, ref, tiling

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"ppswor_transform: {msg}")


def ppswor_transform(keys: torch.Tensor, values: torch.Tensor, p: float,
                     transform_seed) -> torch.Tensor:
    """Transformed values (Eq. 5), of the shape and type of ``values``."""
    if values.device.type == "cpu":
        return ref.ppswor_transform_ref(keys, values, p, transform_seed)
    _require(values.device.type == "cuda",
             f"values on {values.device}; expected a CUDA or CPU tensor")
    _require(values.dtype in DTYPES and values.is_contiguous(),
             "values must be contiguous float32 or bfloat16")
    _require(keys.shape == values.shape and keys.dtype == torch.int32
             and keys.is_contiguous() and keys.device == values.device,
             "keys must be contiguous int32 of values' shape and device")
    n = values.numel()
    _require(n <= _INT_MAX, f"{n} elements")
    out = torch.empty_like(values)
    if n == 0:
        return out
    tseed = int(transform_seed) & hashing.MASK32
    tseed -= 2**32 if tseed >= 2**31 else 0  # a C int: two's-complement wrap
    fn = build.function("ppswor_transform", "worp_ppswor_transform",
                        _ARGTYPES)
    with torch.cuda.device(values.device):
        err = fn(keys.data_ptr(), values.data_ptr(), out.data_ptr(), n, tseed,
                 -1.0 / p, DTYPES[values.dtype], tiling.grid_1d(n),
                 tiling.THREADS_PER_BLOCK,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ppswor_transform kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
