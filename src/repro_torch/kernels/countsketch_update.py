"""Dense segment sketch: the wrappers of ``csrc/countsketch_update.cu``.

``countsketch_update_batched`` takes B dense segments (stream b holds the
values of keys ``base_keys[b] + i``, ``i < lengths[b]``) and returns their
(B, rows, width) CountSketch delta; ``countsketch_update`` is one segment, a
B = 1 launch of the same kernel.  A CUDA tensor launches the hand-written
kernel (or raises); a CPU tensor takes the plain version in ``ref``.  The
kernel's variant follows from the shape before the launch
(``tiling.table_plan``): the shared-memory table where rows x width fits a
block, else global atomics.  ``launches`` (batched) and ``single_launches``
(one segment) count kernel launches, and nothing else;
``variant_launches`` splits all of them by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing, transforms

from . import build, ref, tiling

launches = 0
single_launches = 0
variant_launches = {"smem": 0, "global": 0}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_SMEM_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                  + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
SCHEMES = {transforms.PPSWOR: 0, transforms.PRIORITY: 1}
_VALUE_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_update: {msg}")


def _launch(values, rows, width, seeds, p, scheme, transform_seeds,
            base_keys, lengths, variant):
    """Check the arguments and launch the kernel once: the (B, rows, width)
    delta and the variant launched (None for an empty batch, which
    launches nothing)."""
    _require(values.device.type == "cuda",
             f"values on {values.device}; expected a CUDA or CPU tensor")
    _require(values.dim() == 2 and values.dtype in _VALUE_DTYPES
             and values.is_contiguous(),
             "values must be contiguous (B, n) float32 or bfloat16")
    _require(0 < rows <= _INT_MAX and 0 < width <= _INT_MAX,
             f"rows={rows}, width={width}")
    _require(p is None or scheme in SCHEMES, f"unknown scheme {scheme!r}")
    B, n = values.shape
    _require(B <= _INT_MAX and n <= _INT_MAX, f"shape {tuple(values.shape)}")
    dev = values.device
    if B * n == 0:
        return torch.zeros((B, rows, width), dtype=torch.float32,
                           device=dev), None
    vals = values.to(torch.float32)  # bfloat16 is cast, as the reference does
    seeds32 = hashing.int32_arg(seeds, B, dev)
    tseeds32 = hashing.int32_arg(
        0 if transform_seeds is None else transform_seeds, B, dev)
    base32 = hashing.int32_arg(0 if base_keys is None else base_keys, B, dev)
    lens32 = tiling.lengths_arg(lengths, B, n, dev)
    plan, delta = tiling.table_launch(B, n, lengths, rows, width, dev,
                                      variant)
    transform = (int(p is not None), -1.0 / p if p is not None else 0.0,
                 SCHEMES.get(scheme, 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "smem":
            ends = None if plan.one_per_stream \
                else tiling.block_ends(lens32, plan.chunk)
            fn = build.function("countsketch_update",
                                "worp_countsketch_update_smem",
                                _SMEM_ARGTYPES)
            err = fn(vals.data_ptr(), seeds32.data_ptr(), tseeds32.data_ptr(),
                     base32.data_ptr(), lens32.data_ptr(),
                     None if ends is None else ends.data_ptr(),
                     delta.data_ptr(), B, n, rows, width, plan.chunk,
                     *transform, plan.blocks, plan.threads, plan.smem_bytes,
                     stream)
        else:
            fn = build.function("countsketch_update",
                                "worp_countsketch_update", _ARGTYPES)
            err = fn(vals.data_ptr(), seeds32.data_ptr(), tseeds32.data_ptr(),
                     base32.data_ptr(), lens32.data_ptr(), delta.data_ptr(),
                     B, n, rows, width, *transform, plan.blocks,
                     plan.threads, stream)
    if err:
        raise RuntimeError(f"countsketch_update kernel launch failed: CUDA "
                           f"error {err}")
    variant_launches[plan.variant] += 1
    return delta, plan.variant


def countsketch_update_batched(values: torch.Tensor, rows: int, width: int,
                               seeds, p: float | None = None,
                               scheme: str = transforms.PPSWOR,
                               transform_seeds=None, base_keys=None,
                               lengths=None, *,
                               _variant: str | None = None) -> torch.Tensor:
    """Sketch B dense segments in one launch; returns the (B, rows, width)
    delta.

    ``values`` is (B, n) float32 (bfloat16 is cast); stream b holds the
    frequencies of keys ``base_keys[b] + i`` (mod 2**32) for ``i <
    lengths[b]``, and later columns are ignored, so ragged streams batch
    together.  With ``p`` set the bottom-k transform of ``scheme`` is fused.
    Seeds and base keys are uint32 values.  ``_variant`` ("smem" or
    "global") forces a kernel variant, for tests and measurements."""
    if values.device.type == "cpu":
        return ref.countsketch_update_batched_ref(
            values, rows, width, seeds, p=p, transform_seeds=transform_seeds,
            base_keys=base_keys, lengths=lengths, scheme=scheme)
    delta, launched = _launch(values, rows, width, seeds, p, scheme,
                              transform_seeds, base_keys, lengths, _variant)
    if launched:
        global launches
        launches += 1
    return delta


def countsketch_update(values: torch.Tensor, rows: int, width: int, seed,
                       p: float | None = None,
                       scheme: str = transforms.PPSWOR, transform_seed=0,
                       base_key=0, *,
                       _variant: str | None = None) -> torch.Tensor:
    """Sketch one dense segment: (n,) values of keys ``base_key + i`` ->
    (rows, width) table, with the fused transform when ``p`` is set."""
    if values.device.type == "cpu":
        return ref.countsketch_update_ref(values, base_key, rows, width, seed,
                                          p=p, transform_seed=transform_seed,
                                          scheme=scheme)
    _require(values.dim() == 1, f"values must be (n,), got shape "
             f"{tuple(values.shape)}")
    delta, launched = _launch(values[None], rows, width, seed, p, scheme,
                              transform_seed, base_key, None, _variant)
    if launched:
        global single_launches
        single_launches += 1
    return delta[0]
