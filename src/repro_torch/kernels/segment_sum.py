"""Sorted segment sum: the wrapper of ``csrc/segment_sum.cu``.

``segment_sum(values, seg)`` sums each row's runs of equal segment ids
(``seg`` nondecreasing from 0 in steps of 0 or 1, as a stable key sort
leaves them): segment s's sum at index s, zero past the last.  A CUDA
tensor launches the hand-written kernel, which adds each run in index
order, so every launch gives the same bits (PyTorch's CPU ``scatter_add_``
adds in that order too, and gives the same bits); a CPU tensor takes the
plain version in ``ref``.  ``core.worp.segment_sum`` calls it under
``torch.use_deterministic_algorithms(True)``.  ``launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref, tiling

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"segment_sum: {msg}")


def segment_sum(values: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-row sums of ``values`` (..., n) float32 over the runs of ``seg``
    (..., n) int64: (..., n) float32."""
    if values.device.type == "cpu":
        return ref.segment_sum_ref(values, seg)
    _require(values.device.type == "cuda",
             f"values on {values.device}; expected a CUDA or CPU tensor")
    _require(values.dtype == torch.float32 and values.dim() >= 1,
             "values must be float32 (..., n)")
    _require(seg.shape == values.shape and seg.dtype == torch.int64
             and seg.device == values.device,
             "seg must be int64 of values' shape and device")
    values, seg = values.contiguous(), seg.contiguous()
    out = torch.zeros_like(values)
    n = values.shape[-1]
    if values.numel() == 0:
        return out
    rows = values.numel() // n
    fn = build.function("segment_sum", "worp_segment_sum", _ARGTYPES)
    with torch.cuda.device(values.device):
        err = fn(values.data_ptr(), seg.data_ptr(), out.data_ptr(), rows, n,
                 tiling.grid_1d(rows * n), tiling.THREADS_PER_BLOCK,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
