"""The port's dry-run tooling (``repro_torch.launch.dryrun``,
``launch.mesh``, ``roofline.analyzer``, the abstract trees and the layer
knobs) against the JAX package's, on the CPU, on meta tensors.

* Shapes and dtypes: ``abstract_params``, ``abstract_cache``,
  ``input_specs`` and ``adamw.abstract_state`` equal the reference's
  ``ShapeDtypeStruct``s for all ten architectures x four shapes.
* Shard shapes: every leaf's per-card shape under the reference's pod
  meshes, (16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod",
  "data", "model")``, equals ``NamedSharding(AbstractMesh(...),
  P(*resolve_pspec(...))).shard_shape(...)`` -- those meshes are a parity
  fixture only; the port's own layouts are ``launch.mesh.LAYOUTS``.
* The analyzer's pure functions equal the reference's; a reduced dense
  model's counted FLOPs equal the analytic count of its products; the
  cut-depth extrapolation equals a full count at a reduced depth, exactly.
* The collective term is unknown (None), not zero, wherever the mesh's
  ``model`` axis holds tensor-parallel collectives the analyzer does not
  reckon; ``elastic.plan_remesh`` gives the same ``launch.mesh.Mesh``.
* ``dryrun.main`` finishes on a reduced configuration of every family.
"""
import dataclasses
import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.roofline import analyzer as jan
from repro_torch.configs.base import ARCH_NAMES, SHAPES, ShapeCell, get_config
from repro_torch.distributed import pytree
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.roofline import analyzer

jax.config.update("jax_platform_name", "cpu")

POD_MESHES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _sig(leaves):
    return [(tuple(x.shape), _dt(x)) for x in leaves]


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's abstract trees for every arch x shape (one pass)."""
    out = {}
    for name in ARCH_NAMES:
        cfg = jget_config(name)
        params = JM.abstract_params(cfg)
        out[name, "params"] = _sig(jax.tree_util.tree_leaves(params))
        out[name, "opt"] = _sig(jax.tree_util.tree_leaves(
            jadamw.abstract_state(params)))
        for sname, shape in JSHAPES.items():
            specs = JM.input_specs(cfg, shape)
            out[name, sname] = {k: _sig(jax.tree_util.tree_leaves(v))
                                for k, v in specs.items()}
    return out


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_trees_match_reference(name, reference_specs):
    cfg = get_config(name)
    params = M.abstract_params(cfg)
    assert all(x.device.type == "meta" for x in pytree.leaves(params))
    assert _sig(pytree.leaves(params)) == reference_specs[name, "params"]
    assert _sig(pytree.leaves(adamw.abstract_state(params))) == \
        reference_specs[name, "opt"]
    for sname, shape in SHAPES.items():
        specs = M.input_specs(cfg, shape)
        got = {k: _sig(pytree.leaves(v)) for k, v in specs.items()}
        assert got == reference_specs[name, sname], (name, sname)
        if shape.kind == "decode":
            cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
            assert _sig(pytree.leaves(cache)) == \
                reference_specs[name, sname]["cache"]


def _trees(cfg):
    """Every PD tree the dry-run shards: parameters and the decode caches
    of both decode shapes."""
    yield T.param_tree(cfg)
    for shape in SHAPES.values():
        if shape.kind == "decode":
            yield T.cache_tree(cfg, shape.global_batch, shape.seq_len)


@pytest.mark.parametrize("mesh_name", sorted(POD_MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_shard_shapes_match_named_sharding(name, mesh_name):
    sizes, axes = POD_MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, axes)
    tmesh_ = tmesh.make_mesh_auto(sizes, axes)
    cfg = get_config(name)
    for tree in _trees(cfg):
        pds = P.leaves(tree)
        got = [shd.shard_shape(pd.shape, pd.axes, tmesh_) for pd in pds]
        want = [tuple(NamedSharding(jmesh, JP(*jshd.resolve_pspec(
            pd.shape, pd.axes, jmesh))).shard_shape(pd.shape)) for pd in pds]
        assert got == want
        assert [tuple(x.shape) for x in P.leaves(
            P.abstract_sharded(tree, tmesh_))] == want
    for shape in SHAPES.values():
        for k, v in M.input_specs(cfg, shape, tmesh_).items():
            if k in ("pos", "cache"):
                continue
            jv = JM.input_specs(jget_config(name), JSHAPES[shape.name],
                                mesh=jmesh)[k]
            assert tuple(v.shape) == tuple(jv.sharding.shard_shape(jv.shape))


def test_production_meshes():
    assert tmesh.make_production_mesh().shape == {"data": 1, "model": 1}
    for layout in tmesh.LAYOUTS:
        m = tmesh.make_production_mesh(layout)
        assert m.shape["model"] <= 8, layout
    assert tmesh.make_production_mesh("multi").size == 256
    with pytest.raises(ValueError, match="unknown layout"):
        tmesh.make_production_mesh("pod")


def test_plan_remesh_gives_the_launch_mesh():
    from repro_torch.train import elastic

    m = elastic.plan_remesh(16, 8, pods=2, device="cpu")
    assert isinstance(m, tmesh.Mesh)
    assert m == tmesh.make_mesh_auto((2, 1, 8), ("pod", "data", "model"),
                                     torch.device("cpu"))
    assert m.axis_names == ("pod", "data", "model") and m.size == 16
    assert tmesh.make_production_mesh("node").device is None


def test_analyzer_pure_functions_match_reference():
    for name in ARCH_NAMES:
        cfg, jcfg = get_config(name), jget_config(name)
        assert analyzer.scan_trip_count(cfg) == jan.scan_trip_count(jcfg)
        for shape in SHAPES.values():
            for chips in (1, 8, 256):
                assert analyzer.model_flops_per_device(
                    M.active_param_count(cfg), shape, chips) == \
                    jan.model_flops_per_device(
                        JM.active_param_count(jcfg), JSHAPES[shape.name],
                        chips)
    for T_ in range(2, 100):
        assert analyzer.unroll_factor(T_) == jan.unroll_factor(T_)
    m1 = {"flops": 10.0, "bytes": 7.0, "coll:x": 1.0}
    mu = {"flops": 16.0, "bytes": 7.5, "coll:x": 0.5}
    assert analyzer.combine_loop_costs(m1, mu, 3, 12) == \
        jan.combine_loop_costs(m1, mu, 3, 12)


def test_flop_count_of_a_reduced_dense_model_is_analytic():
    cfg = get_config("deepseek_67b").reduced()
    B, S = 2, 64
    D, H, Kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    F, Lc = cfg.d_ff, cfg.num_layers
    V = T.param_tree(cfg)["unembed"].shape[1]
    per_layer = (2 * B * S * D * dh * (H + 2 * Kh)    # q, k, v
                 + 2 * B * S * H * dh * D             # out
                 + 2 * 2 * B * H * S * S * dh         # scores, p @ v
                 + 3 * 2 * B * S * D * F)             # SwiGLU
    want = Lc * per_layer + 2 * B * S * D * V         # unembedding
    params = M.abstract_params(cfg, dtype=torch.float32)
    batch = M.input_specs(cfg, ShapeCell("p", S, B, "prefill"))
    from repro_torch.train import steps
    _, got = analyzer.count_step(lambda p, b: steps.serve_prefill(p, b, cfg),
                                 params, batch)
    assert got["flops"] == want
    # train: forward + backward = 3 x the forward's products
    tb = M.input_specs(cfg, ShapeCell("t", S, B, "train"))
    state = steps.TrainState(params, adamw.abstract_state(params))
    _, tr = analyzer.count_step(lambda s, b: steps.train_step(s, b, cfg),
                                state, tb)
    assert tr["flops"] == 3 * want
    assert tr["saved"] > 0 and tr["output"] > 0


CUT = {"deepseek_67b": dict(num_layers=6),
       "gemma2_2b": dict(num_layers=8),
       "olmoe_1b_7b": dict(num_layers=4),
       "mamba2_13b": dict(num_layers=4),
       "recurrentgemma_9b": dict(num_layers=14),
       "seamless_m4t_large_v2": dict(enc_layers=4, dec_layers=4),
       "phi3_vision_42b": dict(num_layers=4)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", sorted(CUT))
def test_cut_depth_extrapolation_equals_full_count(name, kind):
    cfg = dataclasses.replace(get_config(name).reduced(), **CUT[name])
    S = 64 + (cfg.num_patches if cfg.family == "vlm" else 0)
    shape = ShapeCell("x", S, 2, kind)
    T_ = analyzer.scan_trip_count(cfg)
    assert T_ > 1 and analyzer.unroll_factor(T_) < T_
    got, u, _ = dryrun.count_corrected(cfg, shape)
    full = dryrun.count_cell(cfg, shape, T_)
    assert got == full, (u, T_)
    # cost mode is off again: the step runs every layer
    assert L.cost_trips(7) == 7


def test_dense_cost_mode_attention_matches_blockwise():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 16, generator=g)
    k = torch.randn(2, 64, 2, 16, generator=g)
    v = torch.randn(2, 64, 2, 16, generator=g)
    kw = dict(causal=True, window=24, logit_cap=50.0, q_block=16,
              kv_block=32)
    plain = L.blockwise_attention(q, k, v, **kw)
    try:
        L.set_cost_mode(dense_attn=True, unroll=1)
        dense = L.blockwise_attention(q, k, v, **kw)
    finally:
        L.set_cost_mode()
    torch.testing.assert_close(dense, plain, rtol=1e-5, atol=1e-5)


def test_moe_forward_runs_on_meta():
    cfg = get_config("olmoe_1b_7b").reduced()
    params = M.abstract_params(cfg, dtype=torch.float32)
    batch = M.input_specs(cfg, ShapeCell("t", 64, 2, "train"))
    logits = T.forward_train(params, batch, cfg)
    assert logits.device.type == "meta"
    assert tuple(logits.shape[:2]) == (2, 64)


def _reduced_shapes():
    return {"train_4k": ShapeCell("train_4k", 64, 2, "train"),
            "prefill_32k": ShapeCell("prefill_32k", 128, 2, "prefill"),
            "decode_32k": ShapeCell("decode_32k", 128, 2, "decode"),
            "long_500k": ShapeCell("long_500k", 256, 1, "decode")}


def test_dryrun_main_on_every_reduced_family(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", _reduced_shapes())
    assert dryrun.main(["--out", str(tmp_path), "--mesh", "all"]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(ARCH_NAMES) * 4 * len(tmesh.LAYOUTS)
    for rec in recs:
        assert rec["status"] in ("ok", "skip"), rec
        if rec["status"] == "skip":
            assert rec["shape"] == "long_500k" and "documented" in \
                rec["reason"]
            continue
        cfg = get_config(rec["arch"])
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
        mem = rec["memory_stats"]
        assert mem["peak_bytes"] >= mem["param_bytes"] > 0
        if rec["shape"] == "train_4k":
            assert 0 < rec["optimizer_bytes"] < rec["hbm_bytes"]
        if rec["mesh"] == "card":
            assert rec["coll_bytes"] == 0.0 and rec["t_collective"] == 0.0
        else:
            # a (1, 8) node and the multi-node layout shard over 'model':
            # the tensor-parallel term is not reckoned, so the collective
            # term is unknown and the bottleneck is of the other two
            assert rec["coll_bytes"] is None and rec["t_collective"] is None
            assert rec["coll_breakdown"]["tensor-parallel"] is None
            assert rec["bottleneck"] in ("compute", "memory")
            if rec["mesh"] == "multi" and rec["shape"] == "train_4k":
                # the parameters' FSDP traffic over 'data' is reckoned
                assert rec["coll_breakdown"]["all-gather"] > 0.0
        assert math.isfinite(rec["t_compute"]) and rec["chips"] == \
            tmesh.make_production_mesh(rec["mesh"]).size
        assert cfg.supports(SHAPES[rec["shape"]])
    # cached cells are kept, --force recounts
    assert dryrun.main(["--out", str(tmp_path), "--arch", "gemma2_2b",
                        "--shape", "train_4k"]) == 0
    assert "cached" in capsys.readouterr().out


def test_dryrun_compressed_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", _reduced_shapes())
    assert dryrun.main(["--out", str(tmp_path), "--arch", "mamba2_13b",
                        "--shape", "train_4k", "--mesh", "multi", "--rules",
                        "compressed"]) == 0
    rec = json.loads(next(tmp_path.glob("*compressed.json")).read_text())
    c = rec["compressed"]
    cc = dryrun.COMPRESSED_CC
    assert c["wire_bytes"] == 4 * cc.candidates + 4 * (
        cc.rows * cc.width + cc.k)
    assert c["error_bytes"] == 2 * rec["memory_stats"]["param_bytes"]
    assert c["dense_step_flops"] == rec["flops"]


@pytest.mark.parametrize("layout", sorted(tmesh.LAYOUTS))
def test_collective_term_known_only_without_tensor_parallelism(layout):
    cfg = get_config("gemma2_2b").reduced()
    mesh = tmesh.make_production_mesh(layout)
    tree = T.param_tree(cfg)
    coll = analyzer.collective_bytes(P.leaves(tree),
                                     P.leaves(P.pspecs(tree, mesh)), mesh,
                                     "train")
    shape = ShapeCell("t", 64, 2, "train")
    roof = analyzer.roofline("gemma2_2b", shape, layout, mesh.size,
                             {"flops": 1e12, "bytes": 1e9}, coll, 10**6, {})
    line = analyzer.summarize(roof)
    if mesh.shape["model"] == 1:
        assert "tensor-parallel" not in coll
        assert roof.coll_bytes == 0.0 and roof.t_collective == 0.0
        assert "coll=    0.000ms" in line
    else:
        assert coll["tensor-parallel"] is None
        assert roof.coll_bytes is None and roof.t_collective is None
        assert roof.bottleneck == "compute" and "coll=    unknown" in line
    json.loads(roof.to_json())


def test_card_bytes_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.card_bytes() == (80e9, "no card: an H100's 80e9 B")
