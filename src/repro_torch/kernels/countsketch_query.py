"""Batched CountSketch query: the wrapper of ``csrc/countsketch_query.cu``.

``countsketch_query_batched`` returns the (B, rows, k) signed per-row reads
of B streams, each against its own table and seed.  A CUDA tensor launches
the hand-written kernel (or raises); a CPU tensor takes the plain version in
``ref``.  The median over rows stays outside (``ops.estimate_batched``).
``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing

from . import build, ref, tiling

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_query_batched: {msg}")


def countsketch_query_batched(tables: torch.Tensor, keys: torch.Tensor,
                              seeds) -> torch.Tensor:
    """Per-row signed bucket reads for B streams: (B, rows, k) float32."""
    if tables.device.type == "cpu":
        return ref.countsketch_query_batched_ref(tables, keys, seeds)
    _require(tables.device.type == "cuda",
             f"tables on {tables.device}; expected a CUDA or CPU tensor")
    _require(tables.dim() == 3 and tables.dtype == torch.float32
             and tables.is_contiguous(),
             "tables must be contiguous (B, rows, width) float32")
    B, rows, width = tables.shape
    _require(keys.dim() == 2 and keys.shape[0] == B
             and keys.dtype == torch.int32 and keys.is_contiguous()
             and keys.device == tables.device,
             "keys must be contiguous (B, k) int32 on the tables' device")
    k = keys.shape[1]
    _require(max(B, k, rows, width) <= _INT_MAX and width > 0,
             f"shapes {tuple(tables.shape)}, {tuple(keys.shape)}")
    out = torch.empty((B, rows, k), dtype=torch.float32, device=keys.device)
    if B * k * rows == 0:
        return out
    seeds32 = hashing.to_int32(
        hashing.as_u32(seeds, device=keys.device).expand(B)).contiguous()
    fn = build.function("countsketch_query", "worp_countsketch_query",
                        _ARGTYPES)
    with torch.cuda.device(keys.device):
        err = fn(tables.data_ptr(), keys.data_ptr(), seeds32.data_ptr(),
                 out.data_ptr(), B, k, rows, width, tiling.grid_1d(B * k),
                 tiling.THREADS_PER_BLOCK,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"countsketch_query kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
