"""Batched turnstile scatter: the wrapper of ``csrc/countsketch_scatter.cu``.

``countsketch_scatter_batched`` takes B sparse signed streams and returns
their (B, rows, width) CountSketch delta; ``countsketch_scatter`` is one
stream, a B = 1 launch of the same kernel.  A CUDA tensor launches the
hand-written kernel (or raises); a CPU tensor takes the plain version in
``ref``.  The kernel's variant follows from the mode and the shape before
the launch (``tiling.table_plan``): under
``torch.use_deterministic_algorithms(True)`` the deterministic variant
("det": every cell summed in an order fixed by slot index, the same bits on
every run; a table too large for one block spread over a thread block
cluster, or split across blocks by rows or bucket ranges, with the same
bits), else the shared-memory table
where rows x width fits a block, else global atomics.  ``launches``
(batched) and ``single_launches`` (one stream) count kernel launches, and
nothing else; ``variant_launches`` splits all of them by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing, transforms

from . import build, ref, tiling

launches = 0
single_launches = 0
variant_launches = {"smem": 0, "global": 0, "det": 0}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_SMEM_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                  + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
_DET_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# the cluster entry: the det entry's, with the cluster size and the clash
# bitmaps' bits after ranges
_DET_CLUSTER_ARGTYPES = _DET_ARGTYPES[:15] + [ctypes.c_int] * 2 \
    + _DET_ARGTYPES[15:]
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
                                lengths=None, *,
                                _variant: str | None = None) -> torch.Tensor:
    """Scatter B sparse signed streams; returns the (B, rows, width) delta.

    ``keys``/``values`` are (B, n) int32 / float32; slot (b, i) counts when
    ``i < lengths[b]`` and ``keys[b, i] != -1``.  Values may be negative
    (deletions) and duplicate keys accumulate.  With ``p`` set the bottom-k
    transform of ``scheme`` is fused.  Seeds are uint32 values.
    ``_variant`` ("smem", "global" or "det") forces a kernel variant, for
    tests and measurements."""
    if keys.device.type == "cpu":
        return ref.countsketch_scatter_batched_ref(
            keys, values, rows, width, seeds, p=p,
            transform_seeds=transform_seeds, lengths=lengths, scheme=scheme)
    delta, launched = _launch(keys, values, rows, width, seeds, p, scheme,
                              transform_seeds, lengths, _variant)
    if launched:
        global launches
        launches += 1
    return delta


def countsketch_scatter(keys: torch.Tensor, values: torch.Tensor, rows: int,
                        width: int, seed, p: float | None = None,
                        scheme: str = transforms.PPSWOR, transform_seed=0, *,
                        _variant: str | None = None) -> torch.Tensor:
    """Scatter one sparse signed stream: (n,) int32 keys and float32 values
    -> (rows, width) table, with the fused transform when ``p`` is set."""
    if keys.device.type == "cpu":
        return ref.countsketch_scatter_ref(keys, values, rows, width, seed,
                                           p=p, transform_seed=transform_seed,
                                           scheme=scheme)
    _require(keys.dim() == 1 and values.dim() == 1,
             f"keys and values must be (n,), got shapes "
             f"{tuple(keys.shape)} and {tuple(values.shape)}")
    delta, launched = _launch(keys[None], values[None], rows, width, seed, p,
                              scheme, transform_seed, None, _variant)
    if launched:
        global single_launches
        single_launches += 1
    return delta[0]


def _launch(keys, values, rows, width, seeds, p, scheme, transform_seeds,
            lengths, variant):
    """Check the arguments and launch the kernel once: the (B, rows, width)
    delta and whether a kernel ran (an empty batch launches nothing)."""
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
    dev = keys.device
    if B * n == 0:
        return torch.zeros((B, rows, width), dtype=torch.float32,
                           device=dev), False
    seeds32 = hashing.int32_arg(seeds, B, dev)
    tseeds32 = hashing.int32_arg(
        0 if transform_seeds is None else transform_seeds, B, dev)
    lens32 = tiling.lengths_arg(lengths, B, n, dev)
    plan, delta = tiling.table_launch(
        B, n, lengths, rows, width, dev, variant,
        deterministic=torch.are_deterministic_algorithms_enabled())
    transform = (int(p is not None), -1.0 / p if p is not None else 0.0,
                 SCHEMES.get(scheme, 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "smem":
            ends = None if plan.one_per_stream \
                else tiling.block_ends(lens32, plan.chunk)
            fn = build.function("countsketch_scatter",
                                "worp_countsketch_scatter_smem",
                                _SMEM_ARGTYPES)
            err = fn(keys.data_ptr(), values.data_ptr(), seeds32.data_ptr(),
                     tseeds32.data_ptr(), lens32.data_ptr(),
                     None if ends is None else ends.data_ptr(),
                     delta.data_ptr(), B, n, rows, width, plan.chunk,
                     *transform, plan.blocks, plan.threads, plan.smem_bytes,
                     stream)
        elif plan.variant == "det":
            split = (plan.row_group, plan.ranges)
            if plan.cluster:
                fn = build.function("countsketch_scatter",
                                    "worp_countsketch_scatter_det_cluster",
                                    _DET_CLUSTER_ARGTYPES)
                split += (plan.cluster, tiling.det_clash_bits(plan, width))
            else:
                fn = build.function("countsketch_scatter",
                                    "worp_countsketch_scatter_det",
                                    _DET_ARGTYPES)
            err = fn(keys.data_ptr(), values.data_ptr(), seeds32.data_ptr(),
                     tseeds32.data_ptr(), lens32.data_ptr(),
                     delta.data_ptr(), B, n, rows, width, *transform,
                     *split, plan.blocks, plan.threads, plan.smem_bytes,
                     stream)
        else:
            fn = build.function("countsketch_scatter",
                                "worp_countsketch_scatter", _ARGTYPES)
            err = fn(keys.data_ptr(), values.data_ptr(), seeds32.data_ptr(),
                     tseeds32.data_ptr(), lens32.data_ptr(),
                     delta.data_ptr(), B, n, rows, width, *transform,
                     plan.blocks, plan.threads, stream)
    if err:
        raise RuntimeError(f"countsketch_scatter kernel launch failed: CUDA "
                           f"error {err}")
    variant_launches[plan.variant] += 1
    return delta, True
