"""Pluggable wire codecs for sketch states, checkpoints and merges (PyTorch).

The port's counterpart of ``repro.distributed.codecs``.  A ``Codec``
registry keyed by name, with the reference's five codecs:

    none           lossless passthrough (the default; bitwise-identical wire)
    fp16           IEEE half precision for every float leaf (clamped to the
                   fp16 finite range first)
    q8             symmetric 8-bit quantization with stored fp32 scales
    size_adaptive  q8 for float leaves at/above ``SIZE_ADAPTIVE_THRESHOLD``
                   elements, fp16 below
    q2             the deliberately too-coarse 3-level control of the
                   conformance negative control; never for a real wire

The byte codec is the reference's numpy code, copied: a leaf crosses to the
host, is encoded into an ``EncodedLeaf`` wire image (byte for byte the
reference's for the same values) and decoded there, then goes back to its
own device in its own dtype.  Two leaf kinds of the port need care:

* uint32 seeds live in the port as int64 tensors (``hashing.as_u32``).
  Their wire image carries the raw uint32 bytes with dtype ``"uint32"``,
  as ``convert.state_to_numpy`` gives them, and they count 4 bytes an
  element; every int64 tensor leaf is such a seed leaf.
* bfloat16 is not a numpy float (the reference's ``np.asarray`` of a
  bfloat16 array has a dtype of kind ``'V'``), so it travels raw under
  every codec, with dtype ``"bfloat16"``; its bytes go through
  ``view(torch.int16)``.

Dtype guard: integer, bool, seed and bfloat16 leaves are never quantized.
Scales are per leading-axis slice for ndim >= 2 leaves, one scalar scale
for 0/1-d leaves.  ``fake_quant`` applies the same grid with torch ops on
the tensor's own device (``torch.round`` rounds half to even, as
``np.rint`` does), bit for bit the host grid on finite slices.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.distributed import pytree

# Hivemind switches at 2**16 elements; our sketch tables are orders of
# magnitude smaller than DL weight tensors, so the threshold sits at 2**13 --
# production-width tables (rows x width >= 5x256) land in q8, per-stream
# threshold/value vectors stay fp16.
SIZE_ADAPTIVE_THRESHOLD = 2 ** 13

# largest finite fp16 value; floats are clamped here before the half cast so
# heavy-tailed transformed values saturate instead of becoming inf
FP16_MAX = 65504.0

_Q8_LEVELS = 127   # int8 symmetric: q in [-127, 127]
_Q2_LEVELS = 1     # 3 representable values per slice: -scale, 0, +scale

BFLOAT16 = "bfloat16"


class EncodedLeaf(NamedTuple):
    """One tree leaf as it crosses the wire.

    ``payload`` is the uint8 wire image; ``dtype``/``shape`` describe the
    ORIGINAL array (``"uint32"`` for a port seed leaf, ``"bfloat16"`` for a
    bfloat16 one); ``scale`` carries the per-slice quantization scales for
    the q8/q2 kinds (fp32, one entry per leading-axis slice).
    """
    kind: str                  # "raw" | "fp16" | "q8" | "q2"
    payload: np.ndarray        # uint8
    dtype: str
    shape: tuple
    scale: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        n = int(self.payload.nbytes)
        if self.scale is not None:
            n += int(self.scale.nbytes)
        return n


def _lead(shape) -> int:
    """Number of independent scale slices for a leaf shape."""
    return int(shape[0]) if len(shape) >= 2 else 1


def _is_lossless_dtype(dtype) -> bool:
    """The dtype guard: only real floats may be quantized.  uint32 seeds
    (int64 tensors in the port), int32 keys, bools, bfloat16 and any other
    non-float leaf always travel raw."""
    if isinstance(dtype, torch.dtype):
        return not dtype.is_floating_point or dtype == torch.bfloat16
    if dtype == BFLOAT16:
        return True
    return np.dtype(dtype).kind != "f"


def itemsize(dtype: str) -> int:
    """Bytes an element of a wire dtype name (``"bfloat16"`` too)."""
    return 2 if dtype == BFLOAT16 else np.dtype(dtype).itemsize


def wire_dtype(leaf) -> str:
    """The dtype name a leaf carries on the wire (the reference's
    ``str(np.asarray(leaf).dtype)``): ``"uint32"`` for an int64 tensor."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.int64:
            return "uint32"
        if leaf.dtype == torch.bfloat16:
            return BFLOAT16
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def to_host(leaf) -> np.ndarray:
    """A leaf as the host array the reference would encode: int64 seed
    tensors as uint32, bfloat16 as its uint16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).cpu().numpy().view(
                np.uint16)
        a = t.cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a
    return np.asarray(leaf)


def _quant_encode(arr: np.ndarray, levels: int):
    """Symmetric per-slice quantization: q = rint(x / scale), scale =
    max|slice| / levels.  All-zero slices store scale 0 and decode to 0."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(
        _lead(arr.shape), -1)
    if flat.size:
        mags = np.max(np.abs(flat), axis=1)
    else:
        mags = np.zeros(flat.shape[0], np.float32)
    scale = (mags / np.float32(levels)).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.clip(np.rint(flat / safe[:, None]), -levels, levels).astype(np.int8)
    return q, scale


def _quant_decode(payload: np.ndarray, scale: np.ndarray, shape, dtype
                  ) -> np.ndarray:
    q = payload.view(np.int8).astype(np.float32).reshape(_lead(shape), -1)
    out = q * np.asarray(scale, np.float32).reshape(-1, 1)
    return out.reshape(shape).astype(np.dtype(dtype))


def decode_leaf(enc: EncodedLeaf) -> np.ndarray:
    """Codec-independent decode: the wire image names its own kind, so the
    receiver (checkpoint restore, merge boundary) needs no codec handle.
    A bfloat16 leaf decodes to its uint16 bit patterns (numpy has no
    bfloat16); ``to_tensor`` makes the tensor."""
    if enc.kind == "raw":
        dtype = np.uint16 if enc.dtype == BFLOAT16 else np.dtype(enc.dtype)
        return enc.payload.view(dtype).reshape(enc.shape)
    dtype = np.dtype(enc.dtype)
    if enc.kind == "fp16":
        half = enc.payload.view(np.float16).reshape(enc.shape)
        return half.astype(dtype)
    if enc.kind in ("q8", "q2"):
        return _quant_decode(enc.payload, enc.scale, enc.shape, dtype)
    raise ValueError(f"unknown encoded-leaf kind {enc.kind!r}")


def to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A decoded host array of wire dtype ``dtype`` as a port tensor on
    ``device``: int64 for a uint32 seed leaf, bfloat16 from its bit
    patterns."""
    # a raw leaf decodes to a read-only view of its payload
    arr = np.require(arr, requirements=("C", "W"))
    if dtype == "uint32":
        return hashing.as_u32(arr.astype(np.int64), device=device)
    if dtype == BFLOAT16:
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class Codec:
    """Base wire codec: raw passthrough for every leaf (= codec ``none``).

    Subclasses override ``_float_kind`` to pick a lossy kind per FLOAT leaf;
    the dtype guard in ``leaf_kind`` routes every non-float leaf to raw
    regardless of codec.  ``rel_step`` is the codec's worst-case per-element
    absolute error as a fraction of the slice max-abs (the derived-tolerance
    handle consumed by ``validate/bounds``); ``clamp`` is the finite
    representable bound, if any.
    """
    name = "none"
    rel_step = 0.0
    clamp: Optional[float] = None

    def _float_kind(self, size: int) -> str:
        return "raw"

    def leaf_kind(self, arr) -> str:
        if _is_lossless_dtype(arr.dtype):
            return "raw"
        return self._float_kind(int(np.prod(tuple(arr.shape),
                                            dtype=np.int64)))

    def encode_leaf(self, arr) -> EncodedLeaf:
        """The wire image of a leaf (a tensor on any device, or an array)."""
        dtype = wire_dtype(arr)
        a = to_host(arr)  # a bfloat16 leaf's uint16 bits: raw
        kind = self.leaf_kind(a)
        shape = tuple(int(d) for d in a.shape)
        if kind == "raw":
            payload = np.frombuffer(
                np.ascontiguousarray(a).tobytes(), np.uint8)
            return EncodedLeaf("raw", payload, dtype, shape)
        if kind == "fp16":
            half = np.clip(a, -FP16_MAX, FP16_MAX).astype(np.float16)
            payload = np.frombuffer(half.tobytes(), np.uint8)
            return EncodedLeaf("fp16", payload, dtype, shape)
        levels = _Q8_LEVELS if kind == "q8" else _Q2_LEVELS
        q, scale = _quant_encode(a, levels)
        payload = np.frombuffer(q.tobytes(), np.uint8)
        return EncodedLeaf(kind, payload, dtype, shape, scale)

    def decode_leaf(self, enc: EncodedLeaf) -> np.ndarray:
        return decode_leaf(enc)

    # -- wire accounting (no encode needed; shapes/dtypes decide) ---------
    def payload_nbytes(self, arr) -> int:
        """Bytes this leaf occupies on the wire under this codec."""
        shape = tuple(arr.shape)
        size = int(np.prod(shape, dtype=np.int64))
        dtype = wire_dtype(arr)
        if _is_lossless_dtype(dtype):
            return size * itemsize(dtype)
        return self.float_payload_nbytes(size, _lead(shape))

    def float_payload_nbytes(self, num_elems: int, lead: int = 1) -> int:
        """Wire bytes for a float payload of ``num_elems`` elements carved
        into ``lead`` scale slices."""
        kind = self._float_kind(num_elems)
        if kind == "raw":
            return 4 * num_elems
        if kind == "fp16":
            return 2 * num_elems
        return num_elems + 4 * lead  # int8 payload + fp32 scales

    def tree_nbytes(self, tree) -> int:
        return sum(self.payload_nbytes(leaf) for leaf in pytree.leaves(tree))

    # -- tree boundary ----------------------------------------------------
    def roundtrip(self, tree):
        """Model one wire crossing: each leaf to the host, encoded, decoded,
        and back on its own device in its own dtype.

        The ``none`` codec returns the tree UNTOUCHED (same objects), so the
        default path stays bitwise-identical and copy-free."""
        if self.rel_step == 0.0 and self.clamp is None:
            return tree

        def cross(leaf):
            enc = self.encode_leaf(leaf)
            arr = decode_leaf(enc)
            if not isinstance(leaf, torch.Tensor):
                return arr
            return to_tensor(arr, enc.dtype, leaf.device)

        return pytree.tree_map(cross, tree)

    def roundtrip_atol(self, arr) -> np.ndarray:
        """Per-slice worst-case |decode(encode(x)) - x| bound, broadcastable
        against ``arr`` (zeros for lossless leaves/codecs)."""
        a = to_host(arr)
        if self.leaf_kind(a) == "raw" or a.size == 0:
            return np.zeros((_lead(a.shape), 1), np.float64)
        flat = np.abs(a.astype(np.float64)).reshape(_lead(a.shape), -1)
        m = np.max(flat, axis=1, keepdims=True)
        atol = self.rel_step * m
        if self.clamp is not None:
            atol = np.maximum(atol, m - self.clamp)
        return atol

    # -- quantize-dequantize on the device ---------------------------------
    def fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize-dequantize with torch ops on ``x``'s device, on the SAME
        grid as the host byte codec: bit for bit its decode(encode(x)) on
        finite slices."""
        kind = ("raw" if _is_lossless_dtype(x.dtype)
                else self._float_kind(x.numel()))
        if kind == "raw":
            return x
        if kind == "fp16":
            clip = torch.clamp(x, -FP16_MAX, FP16_MAX)
            return clip.to(torch.float16).to(x.dtype)
        levels = _Q8_LEVELS if kind == "q8" else _Q2_LEVELS
        flat = x.to(torch.float32).reshape(_lead(x.shape), -1)
        mags = torch.amax(torch.abs(flat), dim=1)
        # a true division, as numpy's: CUDA divides by a Python scalar as a
        # multiply by its reciprocal, which may differ in the last bit
        scale = mags / torch.full_like(mags, levels)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(flat / safe[:, None]), -levels, levels)
        return (q * scale[:, None]).reshape(x.shape).to(x.dtype)


class FP16Codec(Codec):
    name = "fp16"
    rel_step = 2.0 ** -11  # half precision: 11-bit significand
    clamp = FP16_MAX

    def _float_kind(self, size: int) -> str:
        return "fp16"


class Q8Codec(Codec):
    name = "q8"
    rel_step = 0.5 / _Q8_LEVELS  # step/2 with step = max/levels

    def _float_kind(self, size: int) -> str:
        return "q8"


class SizeAdaptiveCodec(Codec):
    name = "size_adaptive"
    # worst case across both branches: q8's step dominates fp16's, and the
    # fp16 branch contributes the clamp bound
    rel_step = 0.5 / _Q8_LEVELS
    clamp = FP16_MAX

    def __init__(self, threshold: int = SIZE_ADAPTIVE_THRESHOLD):
        self.threshold = int(threshold)

    def _float_kind(self, size: int) -> str:
        return "q8" if size >= self.threshold else "fp16"


class Q2Codec(Codec):
    """Negative control: 3-level quantization loses ~half of every slice's
    magnitude range.  The conformance admissibility gate must FAIL this
    codec -- if it ever passes, the derived error budgets are vacuous."""
    name = "q2"
    rel_step = 0.5 / _Q2_LEVELS

    def _float_kind(self, size: int) -> str:
        return "q2"


# ---------------------------------------------------------------------------
# registry (mirrors the sampler + plane registries)
# ---------------------------------------------------------------------------

_CODECS: dict = {}


def register_codec(codec: Codec) -> Codec:
    _CODECS[codec.name] = codec
    return codec


register_codec(Codec())
register_codec(FP16Codec())
register_codec(Q8Codec())
register_codec(SizeAdaptiveCodec())
register_codec(Q2Codec())


def available_codecs() -> tuple:
    return tuple(_CODECS)


def get_codec(codec: Union[str, Codec, None]) -> Codec:
    """Resolve a codec handle: None -> ``none``, a name via the registry,
    a ``Codec`` instance as-is."""
    if codec is None:
        return _CODECS["none"]
    if isinstance(codec, Codec):
        return codec
    try:
        return _CODECS[codec]
    except KeyError:
        raise ValueError(
            f"unknown codec {codec!r}; registered: {available_codecs()}"
        ) from None


def fake_quant(x: torch.Tensor, codec: Union[str, Codec, None]
               ) -> torch.Tensor:
    return get_codec(codec).fake_quant(x)


def tree_roundtrip(tree: Any, codec: Union[str, Codec, None]):
    return get_codec(codec).roundtrip(tree)


def tree_nbytes(tree: Any, codec: Union[str, Codec, None] = "none") -> int:
    return get_codec(codec).tree_nbytes(tree)


def assert_trees_within_codec(actual, expected, codec: Union[str, Codec],
                              shards: int = 1, label: str = "") -> None:
    """Parity guard for lossy wires: every float leaf of ``actual`` must sit
    within ``shards`` x the codec's per-slice roundtrip bound of
    ``expected``; lossless leaves must match bit-exactly."""
    cdc = get_codec(codec)
    pairs = zip(pytree.leaves(actual), pytree.leaves(expected))
    for i, (a, e) in enumerate(pairs):
        a, e = to_host(a), to_host(e)
        if _is_lossless_dtype(e.dtype) or cdc.rel_step == 0.0:
            if not np.array_equal(a, e):
                raise AssertionError(
                    f"{label} leaf {i}: lossless leaf differs under codec "
                    f"{cdc.name}")
            continue
        atol = shards * cdc.roundtrip_atol(e) + 1e-7
        diff = np.abs(a.astype(np.float64) - e.astype(np.float64))
        diff = diff.reshape(_lead(e.shape), -1)
        if not np.all(diff <= atol):
            worst = float(np.max(diff - atol))
            raise AssertionError(
                f"{label} leaf {i}: codec {cdc.name} roundtrip error exceeds "
                f"the derived bound by {worst:.3g}")


def describe(codec: Union[str, Codec, None]) -> str:
    c = get_codec(codec)
    clamp = "-" if c.clamp is None else f"{c.clamp:g}"
    return f"codec={c.name} rel_step={c.rel_step:g} clamp={clamp}"


__all__ = [
    "Codec", "EncodedLeaf", "FP16Codec", "Q8Codec", "Q2Codec",
    "SizeAdaptiveCodec", "SIZE_ADAPTIVE_THRESHOLD", "FP16_MAX",
    "available_codecs", "get_codec", "register_codec", "decode_leaf",
    "fake_quant", "tree_roundtrip", "tree_nbytes",
    "assert_trees_within_codec", "describe", "itemsize", "to_host",
    "to_tensor", "wire_dtype",
]
