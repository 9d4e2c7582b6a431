"""Dense segment sketch: the wrappers of ``csrc/countsketch_update.cu``.

``countsketch_update_batched`` takes B dense segments (stream b holds the
values of keys ``base_keys[b] + i``, ``i < lengths[b]``) and returns their
(B, rows, width) CountSketch delta; ``countsketch_update`` is one segment, a
B = 1 launch of the same kernel.  A CUDA tensor launches the hand-written
kernel (or raises); a CPU tensor takes the plain version in ``ref``.  The
kernel's variant follows from the mode and the shape before the launch
(``tiling.table_plan``): under ``torch.use_deterministic_algorithms(True)``
the deterministic variant ("det": each chunk of a segment summed in an
order fixed by slot index, the chunks then in chunk order, the same bits
on every run, ``ref.countsketch_update_det_ref``'s; a table too large for
one block spread over a thread block cluster, or split across blocks by
rows or bucket ranges, with the same bits), else the shared-memory table
where rows x width fits a block, else global atomics.  ``launches``
(batched) and ``single_launches`` (one segment) count kernel launches,
and nothing else;
``variant_launches`` splits all of them by variant.
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
_DET_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
# the cluster entry: the det entry's, with the cluster size and the clash
# bitmaps' bits after ranges
_DET_CLUSTER_ARGTYPES = _DET_ARGTYPES[:18] + [ctypes.c_int] * 2 \
    + _DET_ARGTYPES[18:]


def _packed(argtypes: list) -> list:
    """A ``*_packed`` entry's arguments: its row entry's, with the (B,)
    int64 stream offsets after the values."""
    return argtypes[:1] + [ctypes.c_void_p] + argtypes[1:]


SCHEMES = {transforms.PPSWOR: 0, transforms.PRIORITY: 1}
_VALUE_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"countsketch_update: {msg}")


def _launch(values, rows, width, seeds, p, scheme, transform_seeds,
            base_keys, lengths, variant, offsets=None):
    """Check the arguments and launch the kernel once: the (B, rows, width)
    delta and the variant launched (None for an empty batch, which
    launches nothing).  With ``offsets`` the values are one packed vector
    and ``lengths`` (host ints) say how long each stream is."""
    _require(values.device.type == "cuda",
             f"values on {values.device}; expected a CUDA or CPU tensor")
    _require(values.dim() == (1 if offsets is not None else 2)
             and values.dtype in _VALUE_DTYPES and values.is_contiguous(),
             "values must be contiguous (B, n) float32 or bfloat16, or one "
             "packed (N,) vector with offsets")
    _require(0 < rows <= _INT_MAX and 0 < width <= _INT_MAX,
             f"rows={rows}, width={width}")
    _require(p is None or scheme in SCHEMES, f"unknown scheme {scheme!r}")
    if offsets is not None:
        B, n = len(offsets), max(lengths, default=0)
        offs = torch.as_tensor(offsets, dtype=torch.int64).to(values.device)
    else:
        B, n = values.shape
    _require(B <= _INT_MAX and n <= _INT_MAX, f"{B} streams of at most {n}")
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
    plan, delta = tiling.table_launch(
        B, n, lengths, rows, width, dev, variant,
        deterministic=torch.are_deterministic_algorithms_enabled(),
        det_chunks=True)
    transform = (int(p is not None), -1.0 / p if p is not None else 0.0,
                 SCHEMES.get(scheme, 0))
    packed = offsets is not None

    def entry(name, argtypes):
        # the packed entry takes the offsets after the values
        return build.function("countsketch_update",
                              name + ("_packed" if packed else ""),
                              _packed(argtypes) if packed else argtypes)

    ptrs = (vals.data_ptr(),) + ((offs.data_ptr(),) if packed else ())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "det":
            ends = work = None
            if not plan.one_per_stream:  # chunk tables, summed in order
                ends = tiling.block_ends(lens32, plan.chunk)
                work = torch.empty(
                    (plan.blocks // tiling.det_parts(plan, rows), rows,
                     width), dtype=torch.float32, device=dev)
            split = (plan.row_group, plan.ranges)
            if plan.cluster:
                fn = entry("worp_countsketch_update_det_cluster",
                           _DET_CLUSTER_ARGTYPES)
                split += (plan.cluster, tiling.det_clash_bits(plan, width))
            else:
                fn = entry("worp_countsketch_update_det", _DET_ARGTYPES)
            err = fn(*ptrs, seeds32.data_ptr(), tseeds32.data_ptr(),
                     base32.data_ptr(), lens32.data_ptr(),
                     None if ends is None else ends.data_ptr(),
                     None if work is None else work.data_ptr(),
                     delta.data_ptr(), B, n, rows, width, plan.chunk,
                     *transform, *split, plan.blocks, plan.threads,
                     plan.smem_bytes, stream)
        elif plan.variant == "smem":
            ends = None if plan.one_per_stream \
                else tiling.block_ends(lens32, plan.chunk)
            fn = entry("worp_countsketch_update_smem", _SMEM_ARGTYPES)
            err = fn(*ptrs, seeds32.data_ptr(), tseeds32.data_ptr(),
                     base32.data_ptr(), lens32.data_ptr(),
                     None if ends is None else ends.data_ptr(),
                     delta.data_ptr(), B, n, rows, width, plan.chunk,
                     *transform, plan.blocks, plan.threads, plan.smem_bytes,
                     stream)
        else:
            fn = entry("worp_countsketch_update", _ARGTYPES)
            err = fn(*ptrs, seeds32.data_ptr(), tseeds32.data_ptr(),
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
                               lengths=None, offsets=None, *,
                               _variant: str | None = None) -> torch.Tensor:
    """Sketch B dense segments in one launch; returns the (B, rows, width)
    delta.

    ``values`` is (B, n) float32 (bfloat16 is cast); stream b holds the
    frequencies of keys ``base_keys[b] + i`` (mod 2**32) for ``i <
    lengths[b]``, and later columns are ignored, so ragged streams batch
    together.  With ``offsets`` ``values`` is one packed (N,) vector
    instead, stream b's values ``values[offsets[b]:][:lengths[b]]``
    (``lengths`` host ints; ``offsets`` ints or an int64 tensor, on the
    values' device for no copy), with no padding: the same delta as the
    streams padded into rows.  With ``p`` set the bottom-k transform of
    ``scheme`` is fused.  Seeds and base keys are uint32 values.  ``_variant`` ("smem",
    "global" or "det") forces a kernel variant, for tests and
    measurements."""
    if values.device.type == "cpu":
        if offsets is not None:
            return ref.countsketch_update_packed_ref(
                values, offsets, lengths, rows, width, seeds, p=p,
                transform_seeds=transform_seeds, base_keys=base_keys,
                scheme=scheme)
        return ref.countsketch_update_batched_ref(
            values, rows, width, seeds, p=p, transform_seeds=transform_seeds,
            base_keys=base_keys, lengths=lengths, scheme=scheme)
    delta, launched = _launch(values, rows, width, seeds, p, scheme,
                              transform_seeds, base_keys, lengths, _variant,
                              offsets)
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
