"""Dry-run: count every (arch x shape x mesh) cell of the port on meta
tensors (the port's counterpart of ``repro.launch.dryrun``).

For each cell the step function (``train.steps.train_step``,
``serve_prefill`` or ``serve_step``) runs on ``device="meta"`` stand-ins
(``models.model.abstract_params``, ``input_specs``,
``optim.adamw.abstract_state``): shapes, no storage, no arithmetic.  The
record holds, per card of the mesh:

* memory: the bytes of the parameter, AdamW moment (train) and cache
  (decode) shards and of the inputs, from each leaf's shard shape
  (``distributed.sharding.shard_shape`` under the rule variant); the
  gradients (train); the activations the step saves for backward and the
  new tensors it returns (counted on the global step, split evenly); a
  predicted peak, ``peak_bytes`` (below); and whether that fits the card
  (``total_memory`` where there is one, else ``DEFAULT_CARD_BYTES``, said
  in the record).  The peak is the arguments plus, in train, the larger
  of the saved activations and the gradients with the new parameters and
  moments (the functional AdamW update holds old and new), elsewhere the
  outputs (logits, a prefill's cache); one layer's transients are not
  counted;
* the roofline (``roofline.analyzer``): FLOPs and eager bytes counted on
  the global step and split evenly over the mesh's cards, the
  parameters' collective bytes from their specs; in train, the AdamW
  update's own eager bytes (``optimizer_bytes``).

The reference compiles a deploy program and two cost-mode programs; the
port counts cost mode only: dense attention, each layer loop cut to 1 and
to u trips (u the least divisor > 1 of the trip count T), extrapolated to T
by ``analyzer.combine_loop_costs`` -- so a 32k cell counts 1 + u layers
and no block loop.  The reference's ``--wedge`` flag and its ``qpar`` and
``qpar_nofsdp`` rules (context-parallel attention, ``set_attn_variant``)
shaped only its deploy program's lowering, which cost mode bypasses; the
port has no deploy program, so they have no counterpart here.  A cell
whose shape the architecture does not support (``cfg.supports``) is a
documented skip.  The ``compressed`` rule also
records the error-feedback tree's bytes and the sketch's wire bytes of a
round.

Usage:
  python -m repro_torch.launch.dryrun                   # every cell, one card
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k \\
      --mesh node
  python -m repro_torch.launch.dryrun --rules compressed --force

Records go to ``build/dryrun/<arch>__<shape>__<mesh>[__rules].json`` (a
cached record is kept unless ``--force``).  ``main`` returns 1 if a cell
failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import (ARCH_NAMES, PORT_ARCH_NAMES, SHAPES,
                                     ShapeCell, get_config)
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import LAYOUTS, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, gradcomp
from repro_torch.roofline import analyzer
from repro_torch.train import steps

RESULT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
DEFAULT_CARD_BYTES = 80e9  # an H100's 80 GB, where no card is present

RULE_VARIANTS = {
    "baseline": {},
    # perf-iteration variants.  decode: weights stay fully sharded (embed
    # over data, TP over model); activations replicate batch and shard
    # d_model over data instead.  The KV cache keeps its own batch
    # sharding (cache_batch).
    "decode_tp": {"act_batch": None, "act_embed": ("data",)},
    "cache_data": {"cache_seq": ("data", "model")},
    "no_fsdp": {"embed": None},
    # WORp-compressed DP: params TP-only (replicated over data --
    # compression replaces the dense DP gradient all-reduce)
    "compressed": {"embed": None, "act_batch": None},
}

# the reference's compressed cell's compressor
COMPRESSED_CC = gradcomp.CompressorConfig(k=4096, rows=7, width=31 * 4096,
                                          candidates=512, p=1.0,
                                          mode="twopass")


def card_bytes() -> tuple:
    """(the card's memory, where that number comes from)."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                f"total_memory of {torch.cuda.get_device_name(0)}")
    return DEFAULT_CARD_BYTES, "no card: an H100's 80e9 B"


def _step(cfg, shape: ShapeCell):
    """(the cell's step function, its meta arguments)."""
    params = M.abstract_params(cfg)
    batch = M.input_specs(cfg, shape)
    if shape.kind == "train":
        state = steps.TrainState(params=params,
                                 opt=adamw.abstract_state(params))
        return (lambda s, b: steps.train_step(s, b, cfg),
                (state, batch))
    if shape.kind == "prefill":
        return (lambda p, b: steps.serve_prefill(p, b, cfg),
                (params, batch))
    batch["pos"] = shape.seq_len - 1  # the step takes the position as an int
    return (lambda p, b: steps.serve_step(p, b, cfg), (params, batch))


def count_cell(cfg, shape: ShapeCell, trips: int):
    """One count of the cell's global step on meta tensors in cost mode
    (dense attention, each cut layer loop at ``trips`` trips): the
    analyzer's {"flops", "bytes", "saved"}."""
    fn, args = _step(cfg, shape)
    try:
        L.set_cost_mode(dense_attn=True, unroll=trips)
        return analyzer.count_step(fn, *args)[1]
    finally:
        L.set_cost_mode(dense_attn=False, unroll=1)


def count_corrected(cfg, shape: ShapeCell) -> tuple:
    """The cell's counts at full depth from the cut counts: (metrics, u,
    T)."""
    T_ = analyzer.scan_trip_count(cfg)
    if T_ <= 1:
        return count_cell(cfg, shape, 1), 1, T_
    u = analyzer.unroll_factor(T_)
    m1 = count_cell(cfg, shape, 1)
    mu = count_cell(cfg, shape, u)
    return analyzer.combine_loop_costs(m1, mu, u, T_), u, T_


def memory_per_card(cfg, shape: ShapeCell, mesh, rules: str) -> dict:
    """Bytes of each per-card shard: parameters, moments (train), cache
    (decode), inputs; and the allocator's bytes of the parameters and
    moments (``analyzer.tree_alloc_bytes``)."""
    params = M.abstract_params(cfg, mesh)
    batch = M.input_specs(cfg, shape, mesh)
    out = {"param_bytes": analyzer.tree_bytes(params),
           "param_alloc_bytes": analyzer.tree_alloc_bytes(params)}
    cache = batch.pop("cache", None)
    out["input_bytes"] = analyzer.tree_bytes(batch)
    if shape.kind == "train":
        opt = adamw.abstract_state(params)
        out["moment_bytes"] = analyzer.tree_bytes(opt)
        out["moment_alloc_bytes"] = analyzer.tree_alloc_bytes(opt)
        out["grad_bytes"] = out["param_bytes"]
        if rules == "compressed":
            out["error_bytes"] = analyzer.tree_bytes(
                gradcomp.init_error(params))
    if cache is not None:
        out["cache_bytes"] = analyzer.tree_bytes(cache)
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str = "card",
             rules: str = "baseline", verbose: bool = True, cfg=None,
             shape: ShapeCell = None) -> dict:
    """Count one cell (``cfg`` and ``shape`` override the named ones, as
    the tests' reduced configurations and the card's 8 x 128 steps do)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if not cfg.supports(shape):
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skip",
                "reason": "skipped (documented: needs sub-quadratic "
                          "attention)"}
    mesh = make_production_mesh(mesh_name)
    chips = mesh.size
    t0 = time.time()
    shd.set_mesh(mesh, RULE_VARIANTS[rules])
    try:
        mem = memory_per_card(cfg, shape, mesh, rules)
        metrics, u, T_ = count_corrected(cfg, shape)
        tree = T.param_tree(cfg)
        coll = analyzer.collective_bytes(
            P.leaves(tree), P.leaves(P.pspecs(tree, mesh)), mesh, shape.kind)
    finally:
        shd.set_mesh(None)
    per_card = {k: v / chips for k, v in metrics.items()}
    mem["saved_bytes"] = per_card.pop("saved")
    mem["output_bytes"] = per_card.pop("output")
    args_bytes = (mem["param_bytes"] + mem["input_bytes"]
                  + mem.get("moment_bytes", 0) + mem.get("cache_bytes", 0)
                  + mem.get("error_bytes", 0))
    if shape.kind == "train":
        mem["peak_bytes"] = args_bytes + max(
            mem["saved_bytes"], mem["grad_bytes"] + mem["output_bytes"])
    else:
        mem["peak_bytes"] = args_bytes + mem["output_bytes"]
    limit, limit_src = card_bytes()
    roof = analyzer.roofline(
        arch, shape, mesh_name, chips, per_card, coll,
        M.active_param_count(cfg), mem,
        note=f"rules={rules} cut-depth u={u} T={T_}; flops "
             f"and bytes of the global step / {chips}")
    rec = json.loads(roof.to_json())
    rec.update(status="ok", count_seconds=time.time() - t0, rules=rules,
               fits=mem["peak_bytes"] <= limit,
               card_bytes=limit, card_bytes_source=limit_src,
               global_flops=metrics["flops"], global_bytes=metrics["bytes"],
               trips=[1, u], T=T_)
    if shape.kind == "train":
        # the eager bytes of the AdamW update alone (per card): the share
        # of the step's traffic an optimizer fusion could take
        params = M.abstract_params(cfg)  # gradients have their shapes
        rec["optimizer_bytes"] = analyzer.count_step(
            adamw.update, params, params,
            adamw.abstract_state(params))[1]["bytes"] / chips
    if rules == "compressed" and shape.kind == "train":
        cc = COMPRESSED_CC
        rec["compressed"] = {
            "error_bytes": mem["error_bytes"],
            "wire_bytes": gradcomp._comm_bytes(
                cc, [(cc.rows * cc.width, cc.rows), (cc.k, 1)],
                id_count=cc.candidates),
            "dense_step_flops": per_card["flops"],
            "cc": cc._asdict()}
    if verbose:
        print(analyzer.summarize(roof),
              f"fits={rec['fits']} [{rec['count_seconds']:.1f}s]",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    choices=list(ARCH_NAMES + PORT_ARCH_NAMES))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="card",
                    choices=list(LAYOUTS) + ["all"])
    ap.add_argument("--rules", default="baseline",
                    choices=list(RULE_VARIANTS))
    ap.add_argument("--out", default=str(RESULT_DIR))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(LAYOUTS) if args.mesh == "all" else [args.mesh]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                if args.rules != "baseline":
                    tag += f"__{args.rules}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[dryrun] {tag}: cached")
                    continue
                print(f"[dryrun] {tag}: counting...", flush=True)
                try:
                    rec = run_cell(arch, shape_name, mesh_name, args.rules)
                except Exception as e:  # noqa: BLE001 -- record, keep going
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(tag)
                if rec["status"] == "skip":
                    print(f"[dryrun] {tag}: {rec['reason']}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
