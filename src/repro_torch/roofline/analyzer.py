"""Roofline analysis of the port's steps, counted on meta tensors.

The port's counterpart of ``repro.roofline.analyzer``.  Three terms per
(arch x shape x mesh), in seconds a step PER CARD:

    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective bytes / NVLINK_BW

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled program.  The port has no compiler between it and the card, so
``count_step`` runs the step eagerly on ``device="meta"`` tensors (shapes,
no storage, no arithmetic) and counts:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode``: the products
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention), two
  FLOPs a multiply-add; elementwise ops count none.  The same count of the
  real step on the card is what ``chip_smoke.py`` holds it to.
* bytes with a ``TorchDispatchMode`` that adds, for every aten op that is
  not a view and not an ``empty*`` allocation, the bytes of each tensor it
  takes and each it returns, at their logical sizes.  These are eager,
  unfused bytes: every intermediate crosses HBM once out and once in.
  XLA's "bytes accessed" is of the fused program, so it counts less; the
  two are not comparable.
* saved bytes: the distinct storages autograd saves for backward
  (``torch.autograd.graph.saved_tensors_hooks``), less those of the step's
  own arguments (the parameters, moments and inputs, counted apart).  It is
  the activation memory of a training step, the counterpart of XLA's
  ``temp_size_in_bytes``.
* output bytes: the distinct storages of what the step returns, less its
  arguments' (a decode step's cache, updated in place, is its input's).

The collective term: zero on one card.  On a mesh it is the parameters'
traffic reckoned from their specs (``collective_bytes``).  The
activations' tensor-parallel collectives are not reckoned (ROADMAP): on a
mesh whose ``model`` axis spans more than one card the term is unknown,
so ``coll_bytes`` and ``t_collective`` are None, the breakdown's
``tensor-parallel`` entry is None, and the bottleneck is chosen between
compute and memory alone.

The reference's ``parse_collectives`` and ``_shape_bytes`` read XLA's HLO
text, and ``analyze``/``extract_metrics``/``analyze_corrected`` a compiled
XLA artifact; the port produces neither, so they have no counterpart.

Hardware constants, NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU data
sheet; dense rates, without sparsity, at the 700 W power limit): 989.4
TFLOP/s bf16, 3.35 TB/s HBM3, NVLink 900 GB/s both directions (450 GB/s a
direction).
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989.4e12  # bf16 dense, per card
HBM_BW = 3.35e12       # bytes/s per card
NVLINK_BW = 450e9      # bytes/s per card, one direction


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float               # per-card counted FLOPs
    hbm_bytes: float           # per-card counted (eager) bytes
    coll_bytes: Optional[float]  # per-card collective output bytes; None
    coll_breakdown: Dict[str, Optional[float]]  # where a term is unknown
    t_compute: float
    t_memory: float
    t_collective: Optional[float]
    bottleneck: str            # of the terms that are known
    model_flops: float         # analytic useful flops per card
    useful_ratio: float        # model_flops / flops
    memory_stats: Dict[str, float]
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def model_flops_per_device(active_params: int, shape, chips: int) -> float:
    """Analytic MODEL_FLOPS: 6ND train, 2ND inference (paper-standard)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_params * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_params * tokens / chips
    # decode: one token per sequence
    return 2.0 * active_params * shape.global_batch / chips


def roofline(arch: str, shape, mesh_name: str, chips: int,
             metrics: Dict[str, float], coll: Dict[str, float],
             active_params: int, memory_stats: Dict[str, float],
             note: str = "") -> Roofline:
    """The three terms and the bottleneck from per-card ``metrics``
    (``flops``, ``bytes``) and collective bytes by kind (None: a kind not
    reckoned, which leaves the collective term unknown and out of the
    bottleneck)."""
    flops, hbm = metrics["flops"], metrics["bytes"]
    known = None not in coll.values()
    cbytes = float(sum(coll.values())) if known else None
    t_c, t_m = flops / PEAK_FLOPS, hbm / HBM_BW
    t_x = cbytes / NVLINK_BW if known else None
    terms = {"compute": t_c, "memory": t_m}
    if known:
        terms["collective"] = t_x
    mf = model_flops_per_device(active_params, shape, chips)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops=flops, hbm_bytes=hbm, coll_bytes=cbytes,
        coll_breakdown={k: None if v is None else float(v)
                        for k, v in coll.items()},
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get), model_flops=mf,
        useful_ratio=(mf / flops if flops else 0.0),
        memory_stats=memory_stats, note=note)


def summarize(r: Roofline) -> str:
    coll = ("    unknown" if r.t_collective is None
            else f"{r.t_collective*1e3:9.3f}ms")
    return (f"{r.arch:24s} {r.shape:12s} {r.mesh:6s} "
            f"comp={r.t_compute*1e3:9.3f}ms mem={r.t_memory*1e3:9.3f}ms "
            f"coll={coll} -> {r.bottleneck:10s} "
            f"useful={r.useful_ratio:6.3f}")


# ---------------------------------------------------------------------------
# counting a step on meta tensors
# ---------------------------------------------------------------------------

def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Adds the bytes of every tensor each non-view aten op takes and
    returns (eager, unfused bytes; ``empty*`` allocations move none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func.__name__.startswith("empty"):
            for x in tree_flatten((args, kwargs, out))[0]:
                if isinstance(x, torch.Tensor):
                    self.bytes += tensor_bytes(x)
        return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def count_step(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its FLOPs, eager bytes, saved
    activation bytes and output bytes counted: (its output, {"flops",
    "bytes", "saved", "output"}).  Run it on meta tensors to count a
    full-size step without a card."""
    own = {_storage_key(x) for x in tree_flatten((args, kwargs))[0]
           if isinstance(x, torch.Tensor)}
    saved: dict = {}
    keep = []  # holds every saved tensor, so no storage key is reused

    def pack(t):
        keep.append(t)
        key = _storage_key(t)
        if key not in own:
            saved[key] = t.untyped_storage().nbytes()
        return t

    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with flops, nbytes, torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        out = fn(*args, **kwargs)
    outs = {_storage_key(x): x.untyped_storage().nbytes()
            for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)}
    metrics = {"flops": float(flops.get_total_flops()),
               "bytes": float(nbytes.bytes),
               "saved": float(sum(saved.values())),
               "output": float(sum(v for k, v in outs.items()
                                   if k not in own))}
    del keep
    return out, metrics


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict / tuple tree."""
    return sum(tensor_bytes(x) for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


ALLOC_GRANULE = 512  # the CUDA caching allocator rounds a block to 512 B


def tree_alloc_bytes(tree) -> int:
    """Bytes the caching allocator gives every tensor leaf: each rounded up
    to ``ALLOC_GRANULE`` (a block split off an expandable segment)."""
    return sum(math.ceil(max(tensor_bytes(x), 1) / ALLOC_GRANULE)
               * ALLOC_GRANULE for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# the collective term, from the parameters' specs
# ---------------------------------------------------------------------------

DP_AXES = ("pod", "data")


def collective_bytes(pds, specs, mesh, kind: str,
                     itemsize: int = 2) -> Dict[str, Optional[float]]:
    """Per-card collective output bytes of the parameters' traffic in one
    step, by kind.  For each parameter leaf, with s its per-card shard
    bytes and d the product of the data axes (``pod``, ``data``) its spec
    shards it over:

    * d > 1 (FSDP): an all-gather of the d shards (output d x s) before
      its use, once in prefill and decode, twice in train (forward and
      backward); in train a reduce-scatter of its gradient (output s).
    * d = 1 in train on a mesh whose data axes hold D > 1 cards: an
      all-reduce of its gradient (output s).

    The activations' tensor-parallel collectives are not reckoned: where
    the mesh's ``model`` axis spans more than one card they are there,
    and the ``tensor-parallel`` entry is None (unknown).  On one card
    every term is 0."""
    sizes = mesh.shape
    D = math.prod(sizes.get(ax, 1) for ax in DP_AXES)
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for pd, spec in zip(pds, specs):
        d = math.prod(sizes[ax] for kept in spec if kept for ax in kept
                      if ax in DP_AXES)
        n = math.prod(pd.shape) // math.prod(
            sizes[ax] for kept in spec if kept for ax in kept)
        s = float(n * itemsize)
        if d > 1:
            out["all-gather"] += (2 if kind == "train" else 1) * d * s
            if kind == "train":
                out["reduce-scatter"] += s
        elif kind == "train" and D > 1:
            out["all-reduce"] += s
    if sizes.get("model", 1) > 1:
        out["tensor-parallel"] = None
    return out


# ---------------------------------------------------------------------------
# loop cost correction: count 1 trip and u trips, extrapolate to T
# ---------------------------------------------------------------------------
#
# The reference lowers each cell twice more in cost mode (dense attention)
# with its layer scans unrolled 1 and u times, because XLA counts a loop
# body once: m1 = F + B, mu = F + u*B.  The port runs the first 1 and u
# trips of each cut loop (``models.layers.cost_trips``), which counts the
# same F + u*B.  Then  B = (mu - m1) / (u - 1)  and  true = m1 + (T - 1) * B.

def scan_trip_count(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // 3
    if cfg.layer_pattern == "local_global":
        return cfg.num_layers // 2
    if cfg.family == "encdec":
        return cfg.enc_layers
    return cfg.num_layers


def unroll_factor(T: int) -> int:
    """Smallest divisor > 1 of the trip count (full unroll if prime)."""
    for u in range(2, int(T ** 0.5) + 1):
        if T % u == 0:
            return u
    return T


def combine_loop_costs(m1: Dict[str, float], mu: Dict[str, float],
                       u: int, T: int) -> Dict[str, float]:
    out = {}
    for k in m1:
        body = max((mu.get(k, 0.0) - m1[k]) / (u - 1), 0.0)
        out[k] = m1[k] + (T - 1) * body
    return out
