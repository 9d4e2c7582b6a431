"""CountSketch query: the wrappers of ``csrc/countsketch_query.cu``.

``countsketch_query_batched`` returns the (B, rows, k) signed per-row reads
of B streams, each against its own table and seed; ``countsketch_query`` is
one table, a B = 1 launch of the same kernel, and ``countsketch_estimate``
its median over rows.  A CUDA tensor launches the hand-written kernel (or
raises); a CPU tensor takes the plain version in ``ref``.  The median over
rows stays outside the kernel, with ``jnp.median`` semantics
(``countsketch.median``).  ``launches`` (batched) and ``single_launches``
(one table) count kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import countsketch, hashing

from . import build, ref, tiling

launches = 0
single_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_query: {msg}")


def _launch(tables, keys, seeds) -> torch.Tensor:
    """Check the arguments and launch the kernel once; (B, rows, k)."""
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
    seeds32 = hashing.int32_arg(seeds, B, keys.device)
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
    return out


def countsketch_query_batched(tables: torch.Tensor, keys: torch.Tensor,
                              seeds) -> torch.Tensor:
    """Per-row signed bucket reads for B streams: (B, rows, k) float32."""
    if tables.device.type == "cpu":
        return ref.countsketch_query_batched_ref(tables, keys, seeds)
    out = _launch(tables, keys, seeds)
    if out.numel():  # an empty output launches nothing
        global launches
        launches += 1
    return out


def countsketch_query(table: torch.Tensor, keys: torch.Tensor,
                      seed) -> torch.Tensor:
    """Per-row signed bucket reads of one table: (rows, width) table and
    (k,) int32 keys -> (rows, k) float32."""
    if table.device.type == "cpu":
        return ref.countsketch_query_ref(table, keys, seed)
    _require(table.dim() == 2 and keys.dim() == 1,
             f"expected a (rows, width) table and (k,) keys, got shapes "
             f"{tuple(table.shape)}, {tuple(keys.shape)}")
    out = _launch(table[None], keys[None], seed)[0]
    if out.numel():  # an empty output launches nothing
        global single_launches
        single_launches += 1
    return out


def countsketch_estimate(table: torch.Tensor, keys: torch.Tensor,
                         seed) -> torch.Tensor:
    """R.Est of one table: (k,) median over rows of one query launch."""
    return countsketch.median(countsketch_query(table, keys, seed), 0)
