"""Sketch merge trees: the distributed reduction layer of the port.

The port's counterpart of the merge-tree half of
``repro.distributed.sharding``.  Sampler states are composable: merge(a, b)
is the state of the union of the two shards' data.  Every helper accepts
either a bare merge callable or anything exposing a ``.merge`` attribute
(a ``SamplerSpec``), so the layer works for any registered sampler:

  tree_merge          host-side pairwise tree over a list of states
  merge_states        the selection rule of every host-form aggregation
                      point: the butterfly for power-of-two counts, the
                      tree otherwise
  butterfly_allmerge  the hypercube exchange: round r merges each state
                      with its XOR-partner at distance 2**r.  Host form on
                      a list; collective form over a ``torch.distributed``
                      process group (``batch_isend_irecv`` with the partner
                      rank), where every rank ends with the global state
  psum_sketch         linear-table fast path: ``all_reduce(SUM)`` of a
                      CountSketch table

Seed guards: shards whose uint32 seed leaves (int64 tensors in the port)
differ are not shards of one logical stream, and every form raises rather
than merge them.

The logical-axis half serves the model stack.  Model code annotates
parameters and activations with LOGICAL axis names; ``DEFAULT_RULES`` maps
them to mesh axes, and ``resolve_pspec`` keeps a mapping only where the
mesh has the axis, no earlier dimension claimed it and the dimension
divides, as the reference does.  A mesh here is anything whose ``.shape``
maps axis names to sizes (a ``jax.sharding.Mesh`` or a dict stand-in), and
a spec is a tuple of per-dimension tuples or ``None``, where the reference
gives a ``PartitionSpec``.  ``shard`` is the identity: the port runs its
models on one card.  Where the reference asks its ``named_sharding`` for
a leaf's per-device shape (the dry-run), the port has ``shard_shape``.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from repro_torch.core import hashing
from repro_torch.distributed import codecs as _codecs
from repro_torch.distributed import pytree


# ---------------------------------------------------------------------------
# logical-axis rules (the reference's rule set, copied)
# ---------------------------------------------------------------------------

# FSDP over (pod, data) for big parameter matrices, tensor parallelism over
# 'model' for heads/mlp/vocab/experts, batch over (pod, data); decode KV
# caches shard their sequence axis over 'model'.
DEFAULT_RULES = {
    # params
    "embed": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),
    "layers": None,
    "conv": None,
    "state": None,
    "lru": ("model",),
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": ("model",),
    "act_q_blocks": None,
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "act_lru": ("model",),
    "cache_batch": ("pod", "data"),
    "cache_seq": ("model",),
    "cache_kv": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_CTX = _Ctx()


def set_mesh(mesh, rules: Optional[dict] = None) -> None:
    """Install the active mesh (+ optional rule overrides) for this
    thread."""
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES)
    if rules:
        _CTX.rules.update(rules)


def get_mesh():
    return _CTX.mesh


def get_rules() -> dict:
    return _CTX.rules


def resolve_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh, rules: Optional[dict] = None) -> tuple:
    """Logical axes -> a spec: per dimension the tuple of mesh axes kept,
    or None.  For each dim, the rule's mesh axes are kept only while (a)
    present in ``mesh.shape``, (b) unclaimed by an earlier dim of this
    tensor, and (c) the dim divides by the product of kept axis sizes."""
    rules = rules or _CTX.rules
    if len(shape) != len(axes):
        raise ValueError(f"resolve_pspec: shape {tuple(shape)} and axes "
                         f"{tuple(axes)} differ in length")
    sizes = mesh.shape
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        want = None if name is None else rules.get(name)
        if want is None:
            out.append(None)
            continue
        if isinstance(want, str):
            want = (want,)
        kept, size = [], 1
        for ax in want:
            if ax not in sizes or ax in used:
                continue
            nxt = size * sizes[ax]
            if dim % nxt != 0:
                continue
            kept.append(ax)
            size = nxt
        used.update(kept)
        out.append(tuple(kept) if kept else None)
    return tuple(out)


def shard_shape(shape: Sequence[int], axes: Sequence[Optional[str]],
                mesh, rules: Optional[dict] = None) -> tuple:
    """A leaf's per-card shape on ``mesh``: each dimension divided by the
    product of the mesh axes ``resolve_pspec`` keeps for it (the
    reference's ``named_sharding(...).shard_shape(shape)``)."""
    spec = resolve_pspec(shape, axes, mesh, rules)
    out = []
    for dim, kept in zip(shape, spec):
        n = 1
        for ax in kept or ():
            n *= mesh.shape[ax]
        out.append(dim // n)
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The reference's activation sharding constraint by logical axis
    names: the identity, since the port runs a model on one card."""
    return x


def _resolve_merge(merge_fn):
    """A merge callable, from either a function or a SamplerSpec-like
    object carrying one as ``.merge``."""
    if callable(merge_fn):
        return merge_fn
    merge = getattr(merge_fn, "merge", None)
    if callable(merge):
        return merge
    raise TypeError(
        f"expected a merge callable or a SamplerSpec with .merge, got "
        f"{type(merge_fn).__name__}")


def _seed_pairs(a, b):
    """The seed leaves of two states, pairwise: the port's int64 tensors
    (uint32 seeds) and any uint32 array."""
    for x, y in zip(pytree.leaves(a), pytree.leaves(b)):
        if _codecs.wire_dtype(x) == "uint32":
            yield x, y


def _check_shard_seeds(states: Sequence) -> None:
    """Merge safety: all shards must agree on every seed leaf.

    Shards hashed under different seeds disagree on every r_x/bucket/sign,
    and merging them silently yields garbage samples -- fail loudly instead
    (mirroring ``SketchEngine.merge_with`` and ``worp.check_merge_seeds``).
    """
    for i, st in enumerate(states[1:], start=1):
        for a, b in _seed_pairs(states[0], st):
            if hashing.seeds_concretely_differ(a, b):
                raise ValueError(
                    f"tree_merge: shard 0 and shard {i} carry different "
                    f"hash/transform seeds ({a!r} vs {b!r}); states built "
                    f"from different seeds are not shards of one logical "
                    f"stream and cannot be merged")


def tree_merge(states: Sequence, merge_fn, codec=None):
    """Reduce a list of composable states pairwise: ceil(log2 D) rounds.

    ``codec`` (a name or ``codecs.Codec``) models the wire boundary: each
    shard state is encoded by the sender and decoded on arrival BEFORE the
    seed guard + merge.  Seed/key leaves travel lossless under every codec,
    so the guard is unchanged; ``codec=None``/``"none"`` is a copy-free
    identity."""
    merge_fn = _resolve_merge(merge_fn)
    cdc = _codecs.get_codec(codec)
    states = [cdc.roundtrip(s) for s in states]
    if not states:
        raise ValueError("tree_merge of no states")
    _check_shard_seeds(states)
    while len(states) > 1:
        nxt = [merge_fn(states[i], states[i + 1])
               for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def merge_states(states: Sequence, merge_fn, codec=None):
    """Collapse a host-side list of composable shard states through the
    butterfly for power-of-two shard counts, the pairwise tree otherwise.

    This is THE selection rule for every host-form aggregation point
    (multi-worker serving, the ``fleet`` data plane), so they share one
    seed-agreement contract.  ``codec`` applies ONE wire crossing per shard
    state before merging; callers whose states already crossed the wire
    (the fleet plane restores codec'd checkpoints) must NOT pass one, or
    the states would be quantized twice."""
    states = list(states)
    if not states:
        raise ValueError("merge_states of no states")
    if len(states) == 1:
        states = [_codecs.get_codec(codec).roundtrip(states[0])]
        _check_shard_seeds(states)  # degenerate fleet: still validated
        return states[0]
    if len(states) & (len(states) - 1) == 0:  # power of two: butterfly
        return butterfly_allmerge(states, None, merge_fn, codec=codec)
    return tree_merge(states, merge_fn, codec=codec)


def _check_partner_seeds(a, b, round_idx: int) -> None:
    """butterfly_allmerge's per-round mirror of the ``tree_merge`` guard:
    the XOR-partner's seed leaves must agree with ours before the pair is
    merged."""
    for x, y in _seed_pairs(a, b):
        if hashing.seeds_concretely_differ(x, y):
            raise ValueError(
                f"butterfly_allmerge: round {round_idx} would merge states "
                f"with different hash/transform seeds ({x!r} vs {y!r}); "
                f"shards built from different seeds are not shards of one "
                f"logical stream and cannot be merged (same contract as "
                f"tree_merge)")


def butterfly_rounds(states: list, merge_fn) -> list:
    """The host butterfly's every entry: after log2(D) XOR rounds, entry i
    is what rank i of the collective form holds."""
    d = len(states)
    for r in range(d.bit_length() - 1):
        dist = 1 << r
        for i in range(d):
            _check_partner_seeds(states[i], states[i ^ dist], r)
        states = [merge_fn(states[i], states[i ^ dist]) for i in range(d)]
    return states


def _require_group(group, what: str):
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what}: the collective form needs an initialised "
            f"torch.distributed process group (init_process_group first); "
            f"pass a list of states for the host form")
    return dist


def _exchange(dist, state, peer: int, group):
    """Send every leaf of ``state`` to ``peer`` and receive its state."""
    mine = pytree.leaves(state)
    theirs = [torch.empty_like(t) for t in mine]
    ops = [op for t, u in zip(mine, theirs)
           for op in (dist.P2POp(dist.isend, t.contiguous(), peer, group),
                      dist.P2POp(dist.irecv, u, peer, group))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return pytree.unflatten(state, theirs)


def butterfly_allmerge(state, group, merge_fn, codec=None):
    """O(log D) all-merge for any composable state.

    Two forms:
      * host-side: ``state`` is a LIST/TUPLE of per-shard states
        (``group`` ignored); the XOR-partner rounds run as plain indexing.
        Requires a power-of-two shard count; use ``tree_merge`` for ragged
        counts.
      * collective: ``state`` is this rank's shard, ``group`` a
        ``torch.distributed`` process group (None: the default group).
        Round r exchanges states with rank ``i ^ 2**r`` through
        ``batch_isend_irecv`` and merges ``(own, partner)``, so every rank
        ends with the global state; a group whose size is not a power of
        two takes an ``all_gather`` of every shard and ``tree_merge``.

    Both forms enforce the tree_merge seed-agreement contract.  ``codec``
    (host form only): each shard state crosses the wire encoded ONCE,
    before round 0.  The collective form rejects lossy codecs.
    """
    merge_fn = _resolve_merge(merge_fn)
    cdc = _codecs.get_codec(codec)
    # Host form = a plain list/tuple of shard states.  Sampler states are
    # NamedTuples (tuple subclasses), so match exact types only.
    if isinstance(state, list) or type(state) is tuple:
        states = [cdc.roundtrip(s) for s in state]
        d = len(states)
        if d == 0:
            raise ValueError("butterfly_allmerge of no states")
        if d & (d - 1):
            raise ValueError(
                f"butterfly_allmerge host form needs a power-of-two shard "
                f"count, got {d}; use tree_merge for ragged counts")
        return butterfly_rounds(states, merge_fn)[0]
    if cdc.rel_step != 0.0:
        raise ValueError(
            f"butterfly_allmerge collective form cannot apply lossy codec "
            f"{cdc.name!r} inside the collective; use the host form")
    dist = _require_group(group, "butterfly_allmerge")
    d = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if d == 1:
        return state
    if d & (d - 1):  # not a power of two: gather every shard, then a tree
        gathered = []
        for t in pytree.leaves(state):
            parts = [torch.empty_like(t) for _ in range(d)]
            dist.all_gather(parts, t.contiguous(), group=group)
            gathered.append(parts)
        shards = [pytree.unflatten(state, [g[i] for g in gathered])
                  for i in range(d)]
        return tree_merge(shards, merge_fn)
    for r in range(d.bit_length() - 1):
        peer = rank ^ (1 << r)
        if group is not None:
            peer = dist.get_global_rank(group, peer)
        partner = _exchange(dist, state, peer, group)
        _check_partner_seeds(state, partner, r)
        state = merge_fn(state, partner)
    return state


def psum_sketch(sketch, group=None):
    """Merge CountSketch shards across a process group by an
    ``all_reduce(SUM)`` of the table (linearity); the seed is kept."""
    dist = _require_group(group, "psum_sketch")
    table = sketch.table.clone()
    dist.all_reduce(table, op=dist.ReduceOp.SUM, group=group)
    return type(sketch)(table=table, seed=sketch.seed)
