"""Fault-tolerant checkpointing: atomic, content-verified (PyTorch).

The port's counterpart of ``repro.train.checkpoint``, writing the same
files.  Layout (one directory per step):
    <dir>/step_000042.tmp/...   (written)
    <dir>/step_000042/          (atomic rename on commit)
        manifest.json           {step, leaves: {key: shape, dtype, crc32
                                 [, codec]}, extra}
        <leaf-key>.npy          one uint8 file per tree leaf

Leaf keys are the reference's (``jax.tree_util.keystr`` of the leaf path,
``pytree.leaves_with_path``), the payloads its wire images
(``codecs.Codec.encode_leaf``: uint32 seed leaves raw as uint32, bfloat16
raw with dtype ``"bfloat16"``), and the manifest its JSON, so a state
carried across by ``convert.py`` and saved from either package under the
same codec gives byte-identical files, and either package restores the
other's checkpoints.  CRC32s run over the ENCODED bytes; the manifest
records the codec kind and scales per lossy leaf, and ``restore`` decodes
from the manifest alone.  ``codec="none"`` writes the pre-codec format.

``restore(..., device=None)`` puts every tensor leaf on the card (it
raises with no card unless the caller passes ``device="cpu"``); a numpy
leaf of ``like`` comes back as a numpy array.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed import codecs as _codecs
from repro_torch.distributed import pytree


def _leaf_key(path: str) -> str:
    return path.replace("'", "").replace("[", ".").replace(
        "]", "").strip(".").replace("/", "_") or "root"


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None,
         codec=None) -> str:
    """Write a checkpoint; returns the committed path.

    ``codec``: a ``codecs`` name/instance.  Float leaves are stored as the
    codec's wire image (CRC over the ENCODED bytes); integer/seed/key leaves
    always stay raw (dtype guard)."""
    os.makedirs(directory, exist_ok=True)
    cdc = _codecs.get_codec(codec)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in pytree.leaves_with_path(tree):
        key = _leaf_key(path)
        enc = cdc.encode_leaf(leaf)
        np.save(os.path.join(tmp, key + ".npy"), enc.payload)
        meta = {
            "shape": list(enc.shape),
            "dtype": enc.dtype,
            "crc32": zlib.crc32(enc.payload.tobytes()),
        }
        if enc.kind != "raw":
            meta["codec"] = {"kind": enc.kind,
                             "scale": [float(s) for s in enc.scale]
                             if enc.scale is not None else None}
        manifest["leaves"][key] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def gc_tmp(directory: str) -> None:
    """Remove crash residue (.tmp dirs)."""
    if not os.path.isdir(directory):
        return
    for d in os.listdir(directory):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Load a checkpoint into the structure of ``like``: tensor leaves on
    ``device`` (the card unless the caller asks otherwise; no card raises
    unless ``device="cpu"``), in the port's dtypes; numpy leaves of
    ``like`` as numpy arrays."""
    device = resolve_device(device)
    final = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for path, leaf in pytree.leaves_with_path(like):
        key = _leaf_key(path)
        meta = manifest["leaves"][key]
        raw = np.load(os.path.join(final, key + ".npy"))
        if zlib.crc32(raw.tobytes()) != meta["crc32"]:
            raise IOError(f"checkpoint leaf {key} failed CRC validation")
        cmeta = meta.get("codec")
        scale = None
        if cmeta is not None and cmeta["scale"] is not None:
            scale = np.asarray(cmeta["scale"], np.float32)
        # a lossy wire image decodes via the manifest; raw bytes view as the
        # manifest dtype
        arr = _codecs.decode_leaf(_codecs.EncodedLeaf(
            "raw" if cmeta is None else cmeta["kind"], raw, meta["dtype"],
            tuple(meta["shape"]), scale))
        if list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(np.shape(leaf))}")
        out.append(_codecs.to_tensor(arr, meta["dtype"], device)
                   if isinstance(leaf, torch.Tensor) else arr)
    return pytree.unflatten(like, out)


def restore_latest(directory: str, like: Any, device=None):
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like, device), step


def payload_nbytes(committed_path: str) -> int:
    """Wire bytes of a committed checkpoint: encoded payload + stored scales
    per leaf, computed from the manifest alone (no leaf loads)."""
    with open(os.path.join(committed_path, "manifest.json")) as f:
        manifest = json.load(f)
    total = 0
    for meta in manifest["leaves"].values():
        size = int(np.prod(meta["shape"], dtype=np.int64))
        cmeta = meta.get("codec")
        if cmeta is None:
            total += size * _codecs.itemsize(meta["dtype"])
        elif cmeta["kind"] == "fp16":
            total += 2 * size
        else:  # q8/q2: int8 payload + fp32 scales
            total += size + 4 * len(cmeta["scale"] or ())
    return total
