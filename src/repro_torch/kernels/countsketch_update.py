"""Dense segment sketch: the wrappers of ``csrc/countsketch_update.cu``.

``countsketch_update_batched`` takes B dense segments (stream b holds the
values of keys ``base_keys[b] + i``, ``i < lengths[b]``) and returns their
(B, rows, width) CountSketch delta; ``countsketch_update`` is one segment, a
B = 1 launch of the same kernel.  A CUDA tensor launches the hand-written
kernel (or raises); a CPU tensor takes the plain version in ``ref``.
``launches`` (batched) and ``single_launches`` (one segment) count kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing, transforms

from . import build, ref, tiling

launches = 0
single_launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
SCHEMES = {transforms.PPSWOR: 0, transforms.PRIORITY: 1}
_VALUE_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_update: {msg}")


def _launch(values, rows, width, seeds, p, scheme, transform_seeds,
            base_keys, lengths) -> torch.Tensor:
    """Check the arguments and launch the kernel once; (B, rows, width)."""
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
    delta = torch.zeros((B, rows, width), dtype=torch.float32, device=dev)
    if B * n == 0:
        return delta
    vals = values.to(torch.float32)  # bfloat16 is cast, as the reference does
    seeds32 = hashing.int32_arg(seeds, B, dev)
    tseeds32 = hashing.int32_arg(
        0 if transform_seeds is None else transform_seeds, B, dev)
    base32 = hashing.int32_arg(0 if base_keys is None else base_keys, B, dev)
    lens32 = tiling.lengths_arg(lengths, B, n, dev)
    fn = build.function("countsketch_update", "worp_countsketch_update",
                        _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(vals.data_ptr(), seeds32.data_ptr(), tseeds32.data_ptr(),
                 base32.data_ptr(), lens32.data_ptr(), delta.data_ptr(),
                 B, n, rows, width, int(p is not None),
                 -1.0 / p if p is not None else 0.0, SCHEMES.get(scheme, 0),
                 tiling.grid_1d(B * n), tiling.THREADS_PER_BLOCK,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"countsketch_update kernel launch failed: CUDA "
                           f"error {err}")
    return delta


def countsketch_update_batched(values: torch.Tensor, rows: int, width: int,
                               seeds, p: float | None = None,
                               scheme: str = transforms.PPSWOR,
                               transform_seeds=None, base_keys=None,
                               lengths=None) -> torch.Tensor:
    """Sketch B dense segments in one launch; returns the (B, rows, width)
    delta.

    ``values`` is (B, n) float32 (bfloat16 is cast); stream b holds the
    frequencies of keys ``base_keys[b] + i`` (mod 2**32) for ``i <
    lengths[b]``, and later columns are ignored, so ragged streams batch
    together.  With ``p`` set the bottom-k transform of ``scheme`` is fused.
    Seeds and base keys are uint32 values."""
    if values.device.type == "cpu":
        return ref.countsketch_update_batched_ref(
            values, rows, width, seeds, p=p, transform_seeds=transform_seeds,
            base_keys=base_keys, lengths=lengths, scheme=scheme)
    delta = _launch(values, rows, width, seeds, p, scheme, transform_seeds,
                    base_keys, lengths)
    if values.numel():  # an empty batch launches nothing
        global launches
        launches += 1
    return delta


def countsketch_update(values: torch.Tensor, rows: int, width: int, seed,
                       p: float | None = None,
                       scheme: str = transforms.PPSWOR, transform_seed=0,
                       base_key=0) -> torch.Tensor:
    """Sketch one dense segment: (n,) values of keys ``base_key + i`` ->
    (rows, width) table, with the fused transform when ``p`` is set."""
    if values.device.type == "cpu":
        return ref.countsketch_update_ref(values, base_key, rows, width, seed,
                                          p=p, transform_seed=transform_seed,
                                          scheme=scheme)
    _require(values.dim() == 1, f"values must be (n,), got shape "
             f"{tuple(values.shape)}")
    table = _launch(values[None], rows, width, seed, p, scheme,
                    transform_seed, base_key, None)[0]
    if values.numel():  # an empty segment launches nothing
        global single_launches
        single_launches += 1
    return table
