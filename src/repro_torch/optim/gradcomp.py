"""WORp gradient compression for data-parallel training (PyTorch port of
``repro.optim.gradcomp``; the paper's own headline application, Sec. 1).

Per step, over a ``torch.distributed`` process group of D workers:

  1. every worker w forms  a_w = g_w + e_w  (error-feedback memory e_w)
  2. applies the SHARED p-ppswor transform (hash-keyed, so all workers scale
     coordinate x by the same r_x^{-1/p}) and CountSketches it
  3. ``all_reduce(SUM)`` of the sketch over the group -- the ONLY
     large-vector collective is O(rows x width) instead of O(N)
  4. every worker proposes its top-C local candidates; an ``all_gather``
     (concatenated in rank order) unions them
  5. the merged sketch is queried at the candidates; the top-k by
     transformed magnitude are a WOR ell_p sample of (sum_w a_w)
  6. values:  'onepass'  = estimates inverted via Eq. (6)
              'twopass'  = exact sum of a_w at the k sampled ids (the
                distributed form of WORp pass II: k floats, still cheap)
  7. e_w <- a_w zeroed at the sampled ids (error feedback)

The reference runs inside ``shard_map`` over mesh axes; here the
``group`` argument takes that place (None: the default group), and every
function raises without an initialised process group, as
``sharding.psum_sketch`` does.  ``psum`` is ``all_reduce(SUM)``, a tiled
``all_gather`` is ``all_gather`` concatenated in rank order, and
``psum(1.0)`` is the group's world size.  Every float payload crossing a
collective passes ``codecs.fake_quant`` first, on the host codec's grid.

Which paths reach a kernel: ``tree_compress_step_engine`` sketches all
leaves with one launch of the dense update kernel
(``ops.sketch_dense_batch``) and decodes through one estimate-kernel launch
(``engine.onepass_sample_batched``).  The flat and sharded paths are plain
PyTorch (``countsketch.update``/``estimate``), as the reference computes
them outside any kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import countsketch, estimators, hashing, transforms, worp
from repro_torch.distributed import codecs as wire_codecs
from repro_torch.distributed import pytree
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kernel_ops
from repro_torch.trace import span

_NEG = float("-inf")
_EMPTY = -1
# the sharded path's fused (leaf, id) sort key: tag * 2**22 + id % 2**22,
# wrapped to int32 as the reference's int32 arithmetic wraps
_FUSE = 2**22


class CompressorConfig(NamedTuple):
    k: int = 256              # WOR sample size (coordinates kept per step)
    rows: int = 7
    width: int = 2048         # per-row buckets; paper experiments use k x 31
    candidates: int = 512     # local candidate proposals per worker
    p: float = 1.0            # ell_p sampling power over |gradient|
    scheme: str = transforms.PPSWOR  # bottom-k scheme (registry schemes)
    mode: str = "twopass"     # 'onepass' | 'twopass'
    estimator: str = "raw"    # 'raw' (EF-SGD) | 'ht' (unbiased, Eq. 1)
    seed: int = 0x5EED
    # wire codec (repro_torch.distributed.codecs) applied to every FLOAT
    # payload crossing a collective -- the sketch table and the pass-II
    # value sums -- as fake quantization on the host codec's grid;
    # candidate ids are int32 and always travel raw.
    codec: str = "none"


def _comm_bytes(cc: CompressorConfig, float_payloads: Sequence,
                id_count: int) -> float:
    """Static bytes-on-wire per worker per step under ``cc.codec``:
    ``float_payloads`` is ``[(num_elems, scale_slices), ...]`` for the
    float collectives; ``id_count`` int32 ids travel raw."""
    cdc = wire_codecs.get_codec(cc.codec)
    total = 4 * id_count
    for num, lead in float_payloads:
        total += cdc.float_payload_nbytes(int(num), int(lead))
    return float(total)


def _u32(x, device) -> torch.Tensor:
    """A uint32 seed (wrapped) as the port's int64 tensor on ``device``
    (filled there: no copy from the host, so no wait for the card)."""
    return torch.full((), int(x) & hashing.MASK32, dtype=torch.int64,
                      device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _group(group, what: str):
    """(torch.distributed, world size) of ``group``; raises without an
    initialised process group."""
    dist = shd._require_group(group, what)
    return dist, dist.get_world_size(group)


def _psum(dist, x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(dist, x: torch.Tensor, group, world: int,
                dim: int = 0) -> torch.Tensor:
    """A tiled ``all_gather``: every rank's ``x`` concatenated along
    ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _workers(world: int, device) -> torch.Tensor:
    """``psum(1.0)``: the world size as a float32 device tensor (a division
    by a Python scalar runs as a multiply by its reciprocal on the card)."""
    return _f32(float(world), device)


# ---------------------------------------------------------------------------
# the flat path
# ---------------------------------------------------------------------------

def _dedup_ids(ids: torch.Tensor, score: torch.Tensor):
    """Mask duplicate ids (keep first) by setting score to -inf."""
    order = torch.argsort(ids, stable=True)
    si, ss = ids[order], score[order]
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[1:] = si[1:] == si[:-1]
    return si, torch.where(dup, _NEG, ss)


def compress_locally(a: torch.Tensor, cc: CompressorConfig):
    """Worker-local piece: transform + sketch + candidate proposal."""
    dev = a.device
    n = a.shape[0]
    keys = torch.arange(n, dtype=torch.int32, device=dev)
    a32 = a.to(torch.float32)
    ta = transforms.transform_values(keys, a32, cc.p, _u32(cc.seed, dev),
                                     cc.scheme)
    sk = countsketch.init(cc.rows, cc.width, _u32(cc.seed + 1, dev))
    sk = countsketch.update(sk, keys, ta)
    _, cand = worp.top_k(torch.abs(a32), cc.candidates)
    return sk.table, cand.to(torch.int32)


def decode_sample(table: torch.Tensor, cand: torch.Tensor,
                  cc: CompressorConfig):
    """From the MERGED sketch + candidate union, take the top-k WOR sample.

    Returns (ids (k,), est_values (k,), threshold tau*)."""
    dev = table.device
    sk = countsketch.CountSketch(table=table, seed=_u32(cc.seed + 1, dev))
    est_t = countsketch.estimate(sk, cand)  # transformed-domain estimates
    ids, score = _dedup_ids(cand, torch.abs(est_t))
    top_score, top_i = worp.top_k(score, cc.k + 1)
    sel = ids[top_i[:cc.k]]
    est_t_sorted = countsketch.estimate(sk, sel)
    vals = transforms.invert_frequency(sel, est_t_sorted, cc.p,
                                       _u32(cc.seed, dev), cc.scheme)
    return sel, vals, top_score[cc.k]


def compress_step(a_local: torch.Tensor, cc: CompressorConfig, group=None):
    """The full compression round for one flat vector over ``group``.

    Returns (sparse_update (n,), new_error (n,), stats dict)."""
    dist, world = _group(group, "compress_step")
    dev = a_local.device
    n = a_local.shape[0]
    table, cand = compress_locally(a_local, cc)
    # the local table crosses the wire encoded: same grid as the host codec
    table = wire_codecs.fake_quant(table, cc.codec)
    table = _psum(dist, table, group)                      # merge sketches
    cand_all = _all_gather(dist, cand, group, world)       # union
    ids, est_vals, tau = decode_sample(table, cand_all, cc)

    a32 = a_local.to(torch.float32)
    nworkers = _workers(world, dev)
    if cc.mode == "twopass":
        # pass II: exact values of the k sampled coordinates (k floats)
        exact_local = wire_codecs.fake_quant(a32[ids], cc.codec)
        vals = _psum(dist, exact_local, group) / nworkers
    else:
        vals = est_vals / nworkers  # estimates approximate the SUM

    if cc.estimator == "ht":
        # Horvitz-Thompson inverse-probability weights (Eq. 1) -> unbiased
        probs = estimators.inclusion_probability(
            vals, torch.clamp(tau, min=1e-30), cc.p, cc.scheme)
        vals = vals / torch.clamp(probs, min=1e-6)

    idx = ids.to(torch.int64)
    sparse = torch.zeros((n,), dtype=torch.float32, device=dev)
    sparse[idx] = vals
    new_err = a32.clone()
    new_err[idx] = 0.0
    two = cc.mode == "twopass"
    stats = {
        "comm_floats": _f32(cc.rows * cc.width + (2 * cc.k if two else 0),
                            dev),
        "dense_floats": _f32(n, dev),
        "comm_bytes": _f32(_comm_bytes(
            cc, [(cc.rows * cc.width, cc.rows)] + ([(cc.k, 1)] if two
                                                   else []),
            id_count=cc.candidates), dev),
        "dense_bytes": _f32(4 * n, dev),
        "tau": tau,
    }
    return sparse, new_err, stats


def _ravel(tree):
    """``jax.flatten_util.ravel_pytree``: the leaves flattened in leaf
    order into one vector of their promoted dtype, and the inverse.  Where
    every leaf has one dtype the inverse takes a vector of any dtype and
    keeps it (a bfloat16 model's float32 update comes back float32);
    otherwise it wants the promoted dtype back and casts each leaf to its
    own."""
    leaves = pytree.leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32), \
            lambda flat: pytree.unflatten(tree, [])
    dtype = functools.reduce(torch.promote_types, [x.dtype for x in leaves])
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    shapes = [x.shape for x in leaves]
    dtypes = [x.dtype for x in leaves]
    sizes = [x.numel() for x in leaves]
    if all(d == dtype for d in dtypes):
        return flat, lambda vec: pytree.unflatten(tree, [
            c.reshape(s) for c, s in zip(torch.split(vec, sizes), shapes)])

    def unravel(flat):
        if flat.dtype != dtype:
            raise TypeError(f"unravel function given array of dtype "
                            f"{flat.dtype} but expected dtype {dtype}")
        chunks = torch.split(flat, sizes)
        return pytree.unflatten(tree, [c.reshape(s).to(d) for c, s, d
                                       in zip(chunks, shapes, dtypes)])

    return flat, unravel


def tree_compress_step(grads, error, cc: CompressorConfig, group=None):
    """Flatten a gradient tree, run one compression round, unflatten.

    ``error`` is the worker-local EF tree (same structure as grads)."""
    flat_g, unravel = _ravel(grads)
    flat_e, _ = _ravel(error)
    a = flat_g.to(torch.float32) + flat_e
    sparse, new_err, stats = compress_step(a, cc, group)
    return unravel(sparse), unravel(new_err), stats


def init_error(params):
    """The zero error-feedback tree: float32 zeros shaped as each leaf, on
    its device."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


# ---------------------------------------------------------------------------
# per-leaf path (no giant ravel)
# ---------------------------------------------------------------------------

def _leaf_salt(cc: CompressorConfig, leaf_idx: int):
    """Per-leaf transform/sketch salt: a two-level key space (leaf, index)
    so models larger than 2^32 coordinates never collide in the hash
    domain."""
    return np.uint32((cc.seed + 0x9E3779B9 * (leaf_idx + 1)) & 0xFFFFFFFF)


def _fused_key(cand_tag: torch.Tensor, cand_id: torch.Tensor) -> torch.Tensor:
    """``cand_tag * 2**22 + cand_id % 2**22`` in int32 arithmetic (wrapping
    as the reference's does), computed in int64 and wrapped once."""
    fused = (cand_tag.to(torch.int64) * _FUSE
             + torch.remainder(cand_id.to(torch.int64), _FUSE))
    return hashing.to_int32(fused)


def tree_compress_step_sharded(grads, error, cc: CompressorConfig,
                               group=None, cand_per_leaf: int = 64):
    """WORp compression over a gradient TREE without materializing the
    concatenated vector.

    Keys are (leaf, local-index) pairs: each leaf gets its own p-ppswor /
    CountSketch salt, all leaves accumulate into ONE shared table, and the
    candidate set carries (leaf_tag, local_id) arrays.  Values via exact
    pass II (sum of per-worker values at the sampled ids).
    """
    dist, world = _group(group, "tree_compress_step_sharded")
    leaves_g = pytree.leaves(grads)
    leaves_e = pytree.leaves(error)
    sizes = [int(np.prod(tuple(x.shape))) for x in leaves_g]
    dev = leaves_g[0].device

    table = torch.zeros((cc.rows, cc.width), dtype=torch.float32, device=dev)
    cand_tags, cand_ids, accs = [], [], []
    for li, (g, e, size) in enumerate(zip(leaves_g, leaves_e, sizes)):
        a = g.to(torch.float32).reshape(-1) + e.reshape(-1)
        accs.append(a)
        salt = _u32(_leaf_salt(cc, li), dev)
        keys = torch.arange(size, dtype=torch.int64, device=dev)
        ta = transforms.transform_values(keys, a, cc.p, salt, cc.scheme)
        sk = countsketch.update(
            countsketch.CountSketch(table=table, seed=salt ^ 1),
            keys.to(torch.int32), ta)
        table = sk.table
        ncand = min(cand_per_leaf, size)
        _, ci = worp.top_k(torch.abs(a), ncand)
        cand_ids.append(ci.to(torch.int32))
        cand_tags.append(torch.full((ncand,), li, dtype=torch.int32,
                                    device=dev))

    table = wire_codecs.fake_quant(table, cc.codec)  # encoded wire crossing
    table = _psum(dist, table, group)
    cand_id = _all_gather(dist, torch.cat(cand_ids), group, world)
    cand_tag = _all_gather(dist, torch.cat(cand_tags), group, world)

    # estimate every candidate from the merged table with its leaf's salt
    est = torch.zeros(cand_id.shape, dtype=torch.float32, device=dev)
    inv = torch.zeros(cand_id.shape, dtype=torch.float32, device=dev)
    for li in range(len(leaves_g)):
        salt = _u32(_leaf_salt(cc, li), dev)
        sk = countsketch.CountSketch(table=table, seed=salt ^ 1)
        e_t = countsketch.estimate(sk, cand_id)
        est = torch.where(cand_tag == li, e_t, est)
        inv = torch.where(cand_tag == li,
                          transforms.invert_frequency(cand_id, e_t, cc.p,
                                                      salt, cc.scheme),
                          inv)

    # dedup (tag, id) pairs: sort by a fused sort key, mask repeats
    fused = _fused_key(cand_tag, cand_id)
    order = torch.argsort(fused, stable=True)
    f_s = fused[order]
    dup = torch.zeros_like(f_s, dtype=torch.bool)
    dup[1:] = f_s[1:] == f_s[:-1]
    score = torch.where(dup, _NEG, torch.abs(est[order]))
    top_score, top_i = worp.top_k(score, cc.k + 1)
    sel = order[top_i[:cc.k]]
    sel_tag, sel_id = cand_tag[sel], cand_id[sel]
    est_vals = inv[sel]

    nworkers = _workers(world, dev)
    if cc.mode == "twopass":
        vals = torch.zeros((cc.k,), dtype=torch.float32, device=dev)
        for li, (a, size) in enumerate(zip(accs, sizes)):
            hit = (sel_tag == li) & (sel_id < size)
            safe = torch.clamp(sel_id, 0, size - 1).to(torch.int64)
            vals = vals + torch.where(hit, a[safe], 0.0)
        vals = _psum(dist, wire_codecs.fake_quant(vals, cc.codec),
                     group) / nworkers
    else:
        vals = est_vals / nworkers  # estimates approximate the SUM

    sparse_leaves, err_leaves = zip(*(
        _leaf_update(a, g.shape, sel_id, (sel_tag == li) & (sel_id < size),
                     vals)
        for li, (a, size, g) in enumerate(zip(accs, sizes, leaves_g))))
    two = cc.mode == "twopass"
    ncand_total = sum(min(cand_per_leaf, s) for s in sizes)
    stats = {"comm_floats": _f32(
        cc.rows * cc.width + (2 * cc.k if two else 0), dev),
        "dense_floats": _f32(sum(sizes), dev),
        "comm_bytes": _f32(_comm_bytes(
            cc, [(cc.rows * cc.width, cc.rows)] + ([(cc.k, 1)] if two
                                                   else []),
            id_count=2 * ncand_total), dev),  # (tag, id) pairs
        "dense_bytes": _f32(4 * sum(sizes), dev)}
    return (pytree.unflatten(grads, sparse_leaves),
            pytree.unflatten(grads, err_leaves), stats)


def _leaf_update(a, shape, ids, hit, vals):
    """One leaf's sparse update (``vals`` at the ``ids`` where ``hit``) and
    its new error: ``a`` itself, zeroed in place where the update is
    nonzero (``a`` is the step's own accumulation, so no copy is kept).
    Ids that miss (another leaf's, -1, past the leaf's end) go to a dropped
    scratch slot instead of relying on out-of-bounds scatter semantics."""
    size = a.numel()
    safe = torch.where(hit, ids, size).to(torch.int64)
    sp = torch.zeros((size + 1,), dtype=torch.float32, device=a.device)
    sp[safe] = torch.where(hit, vals, 0.0)
    sp = sp[:size]
    return sp.reshape(shape), a.masked_fill_(sp != 0.0, 0.0).reshape(shape)


# ---------------------------------------------------------------------------
# SketchEngine path: per-LAYER gradient streams, one batched kernel launch
# ---------------------------------------------------------------------------

# coordinates of a leaf ranked at once by ``_top_ids`` (8 bytes of key each)
_RANK_CHUNK = 1 << 25
_LOW32 = (1 << 32) - 1


def _top_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of ``worp.top_k(x.abs(), k)`` on a flat ``x`` of at
    least ``k`` and under 2**32 coordinates, in no set order: the k largest
    |x|, ties (and NaNs, the largest) to the lower index.  Each coordinate's
    key is its |x|'s bits over its complemented index, so the keys are
    distinct and ``torch.topk`` on them keeps exactly that set; a chunk of
    ``_RANK_CHUNK`` coordinates is keyed at a time, so the transient memory
    is O(chunk), not a sort of the whole leaf."""
    n = x.numel()
    if not k <= n <= _LOW32:
        raise ValueError(f"_top_ids: k={k} of n={n}")
    best = []
    for c0 in range(0, n, _RANK_CHUNK):
        part = x[c0:c0 + _RANK_CHUNK].abs()
        bits = torch.where(torch.isnan(part), 0x7FC00000,
                           part.view(torch.int32)).to(torch.int64)
        pos = torch.arange(c0, c0 + part.numel(), dtype=torch.int64,
                           device=x.device)
        keys = (bits << 32) | (_LOW32 - pos)
        best.append(torch.topk(keys, min(k, keys.numel()),
                               sorted=False).values)
    keys = best[0] if len(best) == 1 else torch.topk(
        torch.cat(best), k, sorted=False).values
    return _LOW32 - (keys & _LOW32)


@functools.lru_cache(maxsize=16)
def _leaf_tensors(seed: int, sizes: tuple, device: str):
    """The transform seeds of a tree's leaves and where each starts in the
    packed accumulation, on ``device``: made once a tree shape, so a step
    copies nothing from the host."""
    t_seeds = torch.tensor([int(_leaf_salt(CompressorConfig(seed=seed), li))
                            for li in range(len(sizes))], dtype=torch.int64,
                           device=device)
    offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    return (t_seeds, torch.from_numpy(offsets).to(device),
            torch.tensor(sizes, dtype=torch.int64, device=device))


def tree_compress_step_engine(grads, error, cc: CompressorConfig,
                              group=None, k_per_leaf: int = 32,
                              cand_per_leaf: int = 64):
    """WORp compression with one WOR sample PER LAYER (engine data plane).

    Each gradient leaf is one stream of the batched engine: the leaves'
    accumulations a = g + e are packed back to back in one float32 vector
    (host offsets), all leaves' sketches come from one launch of the dense
    update kernel over that vector, the (L, rows, width) table block sums
    across the group, and each layer's top-``k_per_leaf`` sample decodes
    from its own table through one estimate-kernel launch
    (``engine.onepass_sample_batched``).

    Values are exact pass-II sums ('twopass') or Eq.-(6) estimates.

    Memory note: nothing pads a leaf to the largest.  The packed vector is
    O(sum n), and becomes the new error in place; the candidates are taken
    leaf by leaf on views, O(1) in the leaf's size beyond a chunk of keys.
    The results are those of the leaves padded into an (L, n_max) block:
    every leaf proposes ncand = min(cand_per_leaf, n_max) candidates, so a
    leaf shorter than ncand proposes its padded slots past its end, which
    decode to 0 and which the final scatter drops.
    """
    from repro_torch.engine import engine as E

    with span("gradcomp.step"):
        dist, world = _group(group, "tree_compress_step_engine")
        leaves_g = pytree.leaves(grads)
        leaves_e = pytree.leaves(error)
        sizes = tuple(int(np.prod(tuple(x.shape))) for x in leaves_g)
        L, n_max = len(leaves_g), max(sizes)
        dev = leaves_g[0].device
        t_seeds, offs_dev, sizes_dev = _leaf_tensors(
            int(cc.seed), sizes, str(dev))
        sk_seeds = t_seeds ^ 1

        with span("gradcomp.accumulate"):
            packed = torch.empty((sum(sizes),), dtype=torch.float32,
                                 device=dev)
            accs = list(torch.split(packed, sizes))
            for a, g, e in zip(accs, leaves_g, leaves_e):
                torch.add(g.reshape(-1), e.reshape(-1), out=a)

        # 1. batched sketch of all layers in one kernel launch
        with span("gradcomp.sketch"):
            tables = kernel_ops.sketch_dense_batch(
                packed, cc.rows, cc.width, sk_seeds, p=cc.p, scheme=cc.scheme,
                transform_seeds=t_seeds, lengths=sizes,
                offsets=offs_dev)                              # (L, R, W)
            # per-layer scale slices (leading axis L): one layer's magnitude
            # never degrades another's quantization grid
            tables = wire_codecs.fake_quant(tables, cc.codec)
        tables = _psum(dist, tables, group)                    # merge shards

        # 2. per-layer candidate proposals, unioned across workers
        with span("gradcomp.candidates"):
            ncand = min(cand_per_leaf, n_max)
            pad = torch.arange(ncand, dtype=torch.int64, device=dev)
            cand = torch.stack([pad if size < ncand else _top_ids(a, ncand)
                                for a, size in zip(accs, sizes)])
            cand = _all_gather(dist, cand.to(torch.int32), group, world,
                               dim=1)                          # (L, D*ncand)
        # top_k needs k+1 <= candidate count (D*ncand can be tiny on 1 worker)
        k_leaf = min(k_per_leaf, cand.shape[1] - 1)

        # 3. per-layer decode through the engine's batched one-pass sample
        with span("gradcomp.decode"):
            si = torch.sort(cand, dim=1, stable=True).values
            dup = torch.zeros_like(si, dtype=torch.bool)
            dup[:, 1:] = si[:, 1:] == si[:, :-1]
            state = worp.OnePassState(
                sketch=countsketch.CountSketch(table=tables, seed=sk_seeds),
                cand_keys=torch.where(dup, _EMPTY, si).to(torch.int32),
                seed_transform=t_seeds)
            s = E.onepass_sample_batched(state, k_leaf, cc.p, cc.scheme)
            sel, est_vals, tau = s.keys, s.freqs, s.threshold  # (L, k), (L,)
            # fewer than k_leaf unique candidates -> -1 slots; a leaf shorter
            # than ncand may sample its padded slots past its end
            in_leaf = (sel != _EMPTY) & (sel < sizes_dev[:, None])

            nworkers = _workers(world, dev)
            if cc.mode == "twopass":
                at = torch.where(in_leaf, offs_dev[:, None] + sel, 0)
                vals = _psum(dist, wire_codecs.fake_quant(
                    torch.where(in_leaf, packed[at], 0.0), cc.codec),
                    group) / nworkers
            else:
                vals = torch.where(sel != _EMPTY, est_vals, 0.0) / nworkers

        with span("gradcomp.leaf_update"):
            sparse_leaves, err_leaves = zip(*(
                _leaf_update(a, g.shape, sel[li], in_leaf[li], vals[li])
                for li, (a, g) in enumerate(zip(accs, leaves_g))))

        with span("gradcomp.stats"):
            two = cc.mode == "twopass"
            stats = {
                "comm_floats": _f32(
                    L * cc.rows * cc.width + (2 * L * k_leaf if two else 0),
                    dev),
                "dense_floats": _f32(sum(sizes), dev),
                "comm_bytes": _f32(_comm_bytes(
                    cc, [(L * cc.rows * cc.width, L)]
                    + ([(L * k_leaf, L)] if two else []),
                    id_count=L * ncand), dev),
                "dense_bytes": _f32(4 * sum(sizes), dev),
                "tau": tau,
            }
        return (pytree.unflatten(grads, sparse_leaves),
                pytree.unflatten(grads, err_leaves), stats)


__all__ = [
    "CompressorConfig",
    "compress_locally",
    "compress_step",
    "decode_sample",
    "init_error",
    "tree_compress_step",
    "tree_compress_step_engine",
    "tree_compress_step_sharded",
]
