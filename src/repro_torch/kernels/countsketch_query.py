"""CountSketch query and estimate: wrappers of ``csrc/countsketch_query.cu``.

``countsketch_query_batched`` returns the (B, rows, k) signed per-row reads
of B streams, each against its own table and seed (the row-read kernel);
``countsketch_estimate_batched`` their (B, k) median over rows with
``jnp.median`` semantics, from one launch of the estimate kernel, which
takes the median in registers.  ``countsketch_query`` and
``countsketch_estimate`` are one table, B = 1 launches of the same two
kernels.  A CUDA tensor launches a hand-written kernel (or raises); a CPU
tensor takes the plain version in ``ref``.

The estimate kernel holds at most ``MAX_FUSED_ROWS`` reads a key; a table
with more rows takes the row read and ``countsketch.median``, chosen by
shape before the launch.  Each kernel counts its own launches, and nothing
else: ``launches`` and ``single_launches`` the row read (batched, one
table), ``estimate_launches`` and ``estimate_single_launches`` the
estimate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import countsketch, hashing

from . import build, ref, tiling

launches = 0
single_launches = 0
estimate_launches = 0
estimate_single_launches = 0

# kMaxFusedRows of csrc/countsketch_query.cu
MAX_FUSED_ROWS = 16

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the row read's entry: the estimate's and the layout
_QUERY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_query: {msg}")


def _check(tables, keys) -> None:
    """Raise unless the kernels take these (B, rows, width) tables and
    (B, k) keys."""
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
    _require(max(B, keys.shape[1], rows, width) <= _INT_MAX and width > 0,
             f"shapes {tuple(tables.shape)}, {tuple(keys.shape)}")


def fuses(rows: int) -> bool:
    """Whether the estimate of a ``rows``-row table is one launch of the
    estimate kernel (else the row read and ``countsketch.median``)."""
    return 1 <= rows <= MAX_FUSED_ROWS


def _launch(tables, keys, seeds, estimate: bool) -> torch.Tensor:
    """Launch the row read ((B, rows, k) out) or the estimate ((B, k) out)
    once on checked arguments."""
    B, rows, width = tables.shape
    k = keys.shape[1]
    shape = (B, k) if estimate else (B, rows, k)
    out = torch.empty(shape, dtype=torch.float32, device=keys.device)
    if out.numel() == 0:
        return out
    seeds32 = hashing.int32_arg(seeds, B, keys.device)
    if estimate:  # a thread a key
        symbol, argtypes = "worp_countsketch_estimate", _ARGTYPES
        launch = (tiling.grid_1d(B * k), tiling.THREADS_PER_BLOCK)
    else:  # a lane a read, or past one wave a lane a key
        symbol, argtypes = "worp_countsketch_query", _QUERY_ARGTYPES
        launch = tiling.row_read_launch(B, rows, k,
                                        tiling.sm_count(keys.device))
    fn = build.function("countsketch_query", symbol, argtypes)
    with torch.cuda.device(keys.device):
        err = fn(tables.data_ptr(), keys.data_ptr(), seeds32.data_ptr(),
                 out.data_ptr(), B, k, rows, width, *launch,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    return out


def countsketch_query_batched(tables: torch.Tensor, keys: torch.Tensor,
                              seeds) -> torch.Tensor:
    """Per-row signed bucket reads for B streams: (B, rows, k) float32."""
    if tables.device.type == "cpu":
        return ref.countsketch_query_batched_ref(tables, keys, seeds)
    _check(tables, keys)
    out = _launch(tables, keys, seeds, estimate=False)
    if out.numel():  # an empty output launches nothing
        global launches
        launches += 1
    return out


def countsketch_estimate_batched(tables: torch.Tensor, keys: torch.Tensor,
                                 seeds) -> torch.Tensor:
    """R.Est of B streams: (B, k) float32 median over rows (``jnp.median``
    semantics), one launch of the estimate kernel."""
    if tables.device.type == "cpu":
        return ref.countsketch_estimate_batched_ref(tables, keys, seeds)
    _check(tables, keys)
    if not fuses(tables.shape[1]):
        return countsketch.median(
            countsketch_query_batched(tables, keys, seeds), 1)
    out = _launch(tables, keys, seeds, estimate=True)
    if out.numel():
        global estimate_launches
        estimate_launches += 1
    return out


def _one_table(table, keys) -> None:
    _require(table.dim() == 2 and keys.dim() == 1,
             f"expected a (rows, width) table and (k,) keys, got shapes "
             f"{tuple(table.shape)}, {tuple(keys.shape)}")


def countsketch_query(table: torch.Tensor, keys: torch.Tensor,
                      seed) -> torch.Tensor:
    """Per-row signed bucket reads of one table: (rows, width) table and
    (k,) int32 keys -> (rows, k) float32."""
    if table.device.type == "cpu":
        return ref.countsketch_query_ref(table, keys, seed)
    _one_table(table, keys)
    _check(table[None], keys[None])
    out = _launch(table[None], keys[None], seed, estimate=False)[0]
    if out.numel():
        global single_launches
        single_launches += 1
    return out


def countsketch_estimate(table: torch.Tensor, keys: torch.Tensor,
                         seed) -> torch.Tensor:
    """R.Est of one table: (k,) median over rows, one launch of the
    estimate kernel."""
    if table.device.type == "cpu":
        return ref.countsketch_estimate_ref(table, keys, seed)
    _one_table(table, keys)
    _check(table[None], keys[None])
    if not fuses(table.shape[0]):
        return countsketch.median(countsketch_query(table, keys, seed), 0)
    out = _launch(table[None], keys[None], seed, estimate=True)[0]
    if out.numel():
        global estimate_single_launches
        estimate_single_launches += 1
    return out
