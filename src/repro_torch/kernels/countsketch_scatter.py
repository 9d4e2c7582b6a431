"""Batched turnstile scatter: the wrapper of ``csrc/countsketch_scatter.cu``.

``countsketch_scatter_batched`` takes B sparse signed streams and returns
their (B, rows, width) CountSketch delta.  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor takes the plain version in
``ref``.  ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing, transforms

from . import build, ref, tiling

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
SCHEMES = {transforms.PPSWOR: 0, transforms.PRIORITY: 1}
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_scatter_batched: {msg}")


def countsketch_scatter_batched(keys: torch.Tensor, values: torch.Tensor,
                                rows: int, width: int, seeds,
                                p: float | None = None,
                                scheme: str = transforms.PPSWOR,
                                transform_seeds=None,
                                lengths=None) -> torch.Tensor:
    """Scatter B sparse signed streams; returns the (B, rows, width) delta.

    ``keys``/``values`` are (B, n) int32 / float32; slot (b, i) counts when
    ``i < lengths[b]`` and ``keys[b, i] != -1``.  Values may be negative
    (deletions) and duplicate keys accumulate.  With ``p`` set the bottom-k
    transform of ``scheme`` is fused.  Seeds are uint32 values."""
    if keys.device.type == "cpu":
        return ref.countsketch_scatter_batched_ref(
            keys, values, rows, width, seeds, p=p,
            transform_seeds=transform_seeds, lengths=lengths, scheme=scheme)
    _require(keys.device.type == "cuda",
             f"keys on {keys.device}; expected a CUDA or CPU tensor")
    _require(keys.dim() == 2 and keys.dtype == torch.int32
             and keys.is_contiguous(), "keys must be contiguous (B, n) int32")
    _require(values.shape == keys.shape and values.dtype == torch.float32
             and values.is_contiguous() and values.device == keys.device,
             "values must be contiguous float32 of keys' shape and device")
    _require(0 < rows <= _INT_MAX and 0 < width <= _INT_MAX,
             f"rows={rows}, width={width}")
    _require(p is None or scheme in SCHEMES, f"unknown scheme {scheme!r}")
    B, n = keys.shape
    _require(B <= _INT_MAX and n <= _INT_MAX, f"shape {tuple(keys.shape)}")
    delta = torch.zeros((B, rows, width), dtype=torch.float32,
                        device=keys.device)
    if B * n == 0:
        return delta
    seeds32 = hashing.int32_arg(seeds, B, keys.device)
    tseeds32 = hashing.int32_arg(
        0 if transform_seeds is None else transform_seeds, B, keys.device)
    lens32 = tiling.lengths_arg(lengths, B, n, keys.device)
    fn = build.function("countsketch_scatter", "worp_countsketch_scatter",
                        _ARGTYPES)
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), values.data_ptr(), seeds32.data_ptr(),
                 tseeds32.data_ptr(), lens32.data_ptr(), delta.data_ptr(),
                 B, n, rows, width, int(p is not None),
                 -1.0 / p if p is not None else 0.0, SCHEMES.get(scheme, 0),
                 tiling.grid_1d(B * n), tiling.THREADS_PER_BLOCK,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"countsketch_scatter kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return delta
