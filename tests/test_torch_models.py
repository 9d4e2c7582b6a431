"""Port parity: the model families (``repro_torch.models``) against the JAX
package's (``repro.models``), on the CPU.

Parameters are the reference's own, initialized in float32 by
``M.init_params(cfg, PRNGKey(0), dtype=float32)`` and carried across as
numpy (``convert.params_from_numpy``): ``jax.random`` cannot be reproduced
in torch.  Inputs are made with numpy (patch embeddings and frames
N(0, 1) x 0.02, as ``concrete_inputs`` draws them).  The ten architectures
run reduced (2 layers, 3 for the hybrid's (R, R, L) group, d_model 128,
vocab 512).

The reference's enc-dec refuses float32 weights (its encoder scan carries
the bfloat16 frames and meets float32 outputs), so seamless's float32
oracle is the reference's own layer functions (``_attn_apply``,
``_mlp_apply``, ``_cross_apply``, ``_embed``, ``_logits``) composed in
``_encdec_forward``'s order, the frames rounded to bfloat16 and cast to
float32; its decode step is the reference's ``forward_decode`` itself.

Tolerances (float32 throughout; both packages sum matrix products and
softmaxes in their own orders):
  * logits and caches: rtol 1e-4, atol 5e-4 x max(1, max|want|); measured
    up to 2.0e-4 at |want| <= 4.8;
  * seamless's logits and caches: atol 1e-2 x max(1, max|want|) (rtol as
    above): the reference's init gives its cross-attention keys and
    queries elements up to ~20, so the encoder's float32 rounding (3e-5
    of scale) grows about 70-fold through the cross-attention softmax
    (measured 7.1e-4 to 2.1e-3 over three seeds; the other new families
    2e-7 to 6e-5);
  * the loss: rtol 1e-5;
  * gradients: each leaf within 1e-3 x its max|want| (the backward sums
    over batch and sequence; measured up to 2.5e-4 x); seamless's within
    5e-2 x (measured 6.3e-3 to 2.2e-2 x over three seeds, as above);
  * attention variants: the reference's own 2e-4 between variants, and
    1e-5 between a variant and its JAX counterpart (one dataflow);
  * decode against the forward within the port: the reference's 0.1 of
    max|logit| (tests/test_models.py), and in fact within the logits'
    tolerance above.
``param_count`` and ``resolve_pspec`` cover all ten architectures at full
size, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_NAMES, get_config
from repro.distributed import sharding as jshd
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as tshd
from repro_torch.models import layers, moe, params as P
from repro_torch.models import model as M
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

DENSE = ("deepseek_67b", "gemma2_2b", "qwen25_32b", "phi4_mini_38b")
NEW = ("olmoe_1b_7b", "grok1_314b", "mamba2_13b", "recurrentgemma_9b",
       "seamless_m4t_large_v2", "phi3_vision_42b")
ENCDEC = "seamless_m4t_large_v2"
S = 32


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name):
    return get_config(name).reduced(), tbase.get_config(name).reduced()


def _params(cfg, seed=0):
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batches(cfg, toks, seed, **more):
    """The reference's and the port's batch: ``toks``, the vlm's patch
    embeddings or the enc-dec's frames (numpy, N(0, 1) x 0.02), and
    ``more`` arrays."""
    rng = np.random.default_rng(seed + 100)
    arrays = {"tokens": toks, **more}
    if cfg.family == "vlm":
        arrays["patch_embeds"] = (rng.standard_normal(
            (toks.shape[0], cfg.num_patches, cfg.d_model)) * 0.02
        ).astype(np.float32)
    elif cfg.family == "encdec":
        arrays["frames"] = (rng.standard_normal(
            (toks.shape[0], cfg.enc_context, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _patches(cfg):
    return cfg.num_patches if cfg.family == "vlm" else 0


def _ref_encdec(jp, batch, cfg, mode):
    """The reference's ``_encdec_forward`` (train or prefill) from its own
    layer functions, a loop over the layers in place of its scan, the
    frames rounded to bfloat16 and cast to the weights' float32."""
    layer = lambda tree, i: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a[i], tree)
    e = batch["frames"].astype(jnp.bfloat16).astype(jp["embed"].dtype)
    for i in range(cfg.enc_layers):
        lp = layer(jp["enc"], i)
        e, _ = JT._attn_apply(e, lp, cfg, "train", None, None, causal=False)
        e = JT._mlp_apply(e, lp, cfg)
    enc_out = jlayers.rmsnorm(e, jp["enc_final_norm"], cfg.norm_eps)
    x = JT._embed(jp, batch["tokens"], cfg)
    caches = []
    for i in range(cfg.dec_layers):
        lp = layer(jp["dec"], i)
        x, nself = JT._attn_apply(x, lp, cfg, mode, None, None)
        cross = {"k": jlayers.attn_qkv(enc_out, lp["xk"]),
                 "v": jlayers.attn_qkv(enc_out, lp["xv"])}
        x = JT._cross_apply(x, lp, cfg, mode, cross)
        x = JT._mlp_apply(x, lp, cfg)
        caches.append({"self": nself, "cross": cross})
    cache = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *caches)
    return JT._logits(jp, x, cfg), cache


def _ref_train(jp, jb, cfg):
    if cfg.family == "encdec":
        return _ref_encdec(jp, jb, cfg, "train")[0]
    return JT.forward_train(jp, jb, cfg)


def _ref_prefill(jp, jb, cfg):
    if cfg.family == "encdec":
        return _ref_encdec(jp, jb, cfg, "prefill")
    return JT.forward_prefill(jp, jb, cfg)


def _ref_loss(jp, jb, cfg):
    if cfg.family == "encdec":  # JM.train_loss over the composed forward
        return JM.cross_entropy(_ref_train(jp, jb, cfg), jb["labels"])
    return JM.train_loss(jp, jb, cfg)


def _scale(name):
    """The atol scale of logits and caches (the module docstring)."""
    return 1e-2 if name == ENCDEC else 5e-4


def _close(got, want, rtol=1e-4, scale=5e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * max(1.0, float(np.abs(want).max())))


def _close_tree(got, want, scale=5e-4):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], scale)
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            _close(got[k], want[k], scale=scale)


@pytest.mark.parametrize("name", DENSE + NEW)
def test_train_logits_loss_and_gradients_match_reference(name):
    cfg, tcfg = _configs(name)
    jp, tp = _params(cfg)
    toks, labels = _tokens(cfg, (2, 64), 1), _tokens(cfg, (2, 64), 2)
    jb, tb = _batches(cfg, toks, 1, labels=labels)
    with torch.no_grad():
        logits = T.forward_train(tp, tb, tcfg)
    assert logits.shape == (2, 64 + _patches(cfg), tcfg.padded_vocab())
    _close(logits, _ref_train(jp, jb, cfg), scale=_scale(name))
    jloss, jgrad = jax.value_and_grad(lambda p: _ref_loss(p, jb, cfg))(jp)
    leaves = P.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = M.train_loss(tp, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jgrad)
    assert len(want) == len(leaves)
    gscale = 5e-2 if name == ENCDEC else 1e-3
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        assert tuple(leaf.shape) == w.shape
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=gscale * float(np.abs(w).max()))


def _pad_seq(tree, n, seq=S):
    """Grow every kv cache (a ``k``/``v`` leaf (L, B, seq, ...)) by n slots
    on axis 2 (the reference test's pad of a cache of the prompt's
    length); recurrent and SSM states stay as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _pad_seq(v, n, seq)
        elif k in ("k", "v") and v.shape[2] == seq:
            pad = [(0, 0)] * v.ndim
            pad[2] = (0, n)
            out[k] = np.pad(np.asarray(v), pad)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", DENSE + NEW)
def test_prefill_cache_and_decode_step_match_reference(name):
    """Prefill logits and the freshly built cache (gemma2's and the
    hybrid's local layers keep the last ``local_window`` keys; the
    recurrent and SSM states), then one decode step from that cache (ring
    slot pos % W on the local layers), against the reference's."""
    cfg, tcfg = _configs(name)
    jp, tp = _params(cfg, seed=1)
    toks = _tokens(cfg, (2, S + 1), 3)
    jb, tb = _batches(cfg, toks[:, :S], 3)
    jl, jc = _ref_prefill(jp, jb, cfg)
    with torch.no_grad():
        tl, tc = T.forward_prefill(tp, tb, tcfg)
    _close(tl, jl, scale=_scale(name))
    _close_tree(tc, jax.tree_util.tree_map(np.asarray, jc), _scale(name))
    seq = S + _patches(cfg)
    cache = _pad_seq(jax.tree_util.tree_map(np.asarray, jc), 1, seq)
    jd, jnc = JT.forward_decode(jp, {
        "token": jnp.asarray(toks[:, S:]), "pos": jnp.int32(seq),
        "cache": jax.tree_util.tree_map(jnp.asarray, cache)}, cfg)
    with torch.no_grad():
        td, tnc = T.forward_decode(tp, {
            "token": torch.from_numpy(toks[:, S:]), "pos": seq,
            "cache": convert.params_from_numpy(cache, "cpu")}, tcfg)
    assert td.shape == (2, 1, tcfg.padded_vocab())
    _close(td, jd, scale=_scale(name))
    _close_tree(tnc, jax.tree_util.tree_map(np.asarray, jnc), _scale(name))


def test_decode_reproduces_the_reference_ring_after_a_long_prompt():
    """A prompt of 24 tokens past gemma2's reduced 16-key window, not a
    multiple of it: the reference's decode writes ring slot pos % 16 over
    a prefill that kept the last 16 keys in order, so it evicts the wrong
    key and leaves its forward by far more than the reference test's 0.1
    (ROADMAP Queue 3).  The port reproduces that decode step by step."""
    cfg, tcfg = _configs("gemma2_2b")
    jp, tp = _params(cfg)
    P_, n = 24, 8
    toks = _tokens(cfg, (1, P_ + n), 5)
    full = np.asarray(JT.forward_train(jp, {"tokens": jnp.asarray(toks)}, cfg))
    _, jc = JT.forward_prefill(jp, {"tokens": jnp.asarray(toks[:, :P_])}, cfg)
    grow = lambda x: np.pad(np.asarray(x), [(0, 0), (0, 0), (0, n), (0, 0),
                                            (0, 0)]) \
        if x.shape[2] == P_ else np.asarray(x)  # noqa: E731
    jc = jax.tree_util.tree_map(grow, jc)
    with torch.no_grad():
        tc = convert.params_from_numpy(jc, "cpu")
        worst = 0.0
        for i in range(n):
            tok = toks[:, P_ + i:P_ + i + 1]
            jl, jc = JT.forward_decode(jp, {"token": jnp.asarray(tok),
                                            "pos": jnp.int32(P_ + i),
                                            "cache": jc}, cfg)
            tl, tc = T.forward_decode(tp, {"token": torch.from_numpy(tok),
                                           "pos": P_ + i, "cache": tc}, tcfg)
            _close(tl, jl)
            want = full[:, P_ + i]
            worst = max(worst, float(np.abs(np.asarray(jl)[:, 0] - want).max()
                                     / np.abs(want).max()))
    assert worst > 0.1


@pytest.mark.parametrize("name", DENSE + NEW)
def test_decode_matches_forward_within_the_port(name):
    """Prefill S tokens, decode token S, compare with the teacher-forced
    logits at position S (tests/test_models.py's checks, dense and
    recurrent, in the port; the vlm's positions after its patches, the
    enc-dec's decoder over the same frames).  Within the logits'
    tolerance too where the forward drops no MoE choice: its capacity
    over S + 1 tokens is not decode's (one token keeps every choice), and
    grok's capacity factor 1.0 drops some."""
    cfg, tcfg = _configs(name)
    _, tp = _params(cfg, seed=2)
    toks = _tokens(cfg, (1, S + 1), 4)
    _, full_b = _batches(cfg, toks, 4)
    _, pre_b = _batches(cfg, toks[:, :S], 4)
    seq = S + _patches(cfg)
    with torch.no_grad():
        with moe.count_drops() as drops:
            full = T.forward_train(tp, full_b, tcfg)
        _, cache = T.forward_prefill(tp, pre_b, tcfg)
        cache = convert.params_from_numpy(
            _pad_seq(convert.params_to_numpy(cache), 1, seq), "cpu")
        lg, _ = T.forward_decode(tp, {"token": torch.from_numpy(toks[:, S:]),
                                      "pos": seq, "cache": cache}, tcfg)
    want, got = full[:, seq].numpy(), lg[:, 0].numpy()
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-6) < 0.1
    dropped = sum(int(d) for d, _ in drops)
    assert (dropped > 0) == (name == "grok1_314b")
    if not dropped:
        _close(got, want, scale=_scale(name))


def test_gemma2_tied_softcapped_logits_and_gelu():
    """gemma2 keeps its published options in the reduced config: tied
    embeddings, both softcaps, GeGLU, the sqrt(d_model) embedding scale;
    its final logits lie within the softcap."""
    _, tcfg = _configs("gemma2_2b")
    assert (tcfg.tied_embeddings, tcfg.attn_logit_softcap,
            tcfg.final_logit_softcap, tcfg.mlp_act, tcfg.scale_embedding,
            tcfg.layer_pattern) == (True, 50.0, 30.0, "gelu", True,
                                    "local_global")
    tp = M.init_params(tcfg, torch.Generator().manual_seed(0),
                       dtype=torch.float32)
    assert "unembed" not in tp
    batch = M.concrete_inputs(tcfg, tbase.ShapeCell("t", 16, 2, "train"),
                              dtype=torch.float32)
    with torch.no_grad():
        logits = T.forward_train(tp, batch, tcfg)
    assert torch.isfinite(logits).all() and logits.abs().max() < 30.0


class TestAttentionVariants:
    """tests/test_models.py::TestAttentionVariants in the port, each port
    function also held to its JAX counterpart on the same inputs."""

    @staticmethod
    def _qkv(seed, B, S_, H, Kh, dh):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=s).astype(np.float32)
                for s in ((B, S_, H, dh), (B, S_, Kh, dh), (B, S_, Kh, dh))]

    @pytest.mark.parametrize("causal,window,cap", [
        (True, 0, 0.0), (True, 32, 0.0), (False, 0, 0.0), (True, 0, 30.0)])
    def test_blockwise_matches_dense(self, causal, window, cap):
        q, k, v = self._qkv(0, 2, 128, 8, 4, 32)
        kw = dict(causal=causal, window=window, logit_cap=cap)
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        blk = layers.blockwise_attention(tq, tk, tv, q_block=32, kv_block=64,
                                         **kw)
        dense = layers._dense_attention(tq, tk, tv, q_offset=0, **kw)
        np.testing.assert_allclose(blk.numpy(), dense.numpy(), rtol=2e-4,
                                   atol=2e-4)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        np.testing.assert_allclose(blk.numpy(), np.asarray(
            jlayers.blockwise_attention(jq, jk, jv, q_block=32, kv_block=64,
                                        **kw)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dense.numpy(), np.asarray(
            jlayers._dense_attention(jq, jk, jv, q_offset=0, **kw)),
            rtol=1e-5, atol=1e-5)

    def test_wedge_matches_dense_causal(self):
        q, k, v = self._qkv(3, 1, 128, 4, 2, 16)
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        w = layers.blockwise_attention(tq, tk, tv, causal=True, q_block=32,
                                       kv_block=32, wedge=True)
        dense = layers._dense_attention(tq, tk, tv, causal=True, window=0,
                                        logit_cap=0.0, q_offset=0)
        np.testing.assert_allclose(w.numpy(), dense.numpy(), rtol=2e-4,
                                   atol=2e-4)
        jw = jlayers.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=True, q_block=32,
                                         kv_block=32, wedge=True)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("window", [0, 16])
    def test_decode_attention_matches_dense_row(self, window):
        B, S_, H, Kh, dh = 2, 64, 8, 4, 16
        rng = np.random.default_rng(6)
        q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
        kc = rng.normal(size=(B, S_, Kh, dh)).astype(np.float32)
        vc = rng.normal(size=(B, S_, Kh, dh)).astype(np.float32)
        pos = 40
        out = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                      pos, window=window, logit_cap=20.0)
        want = jlayers.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                        jnp.int32(pos), window=window,
                                        logit_cap=20.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        if window:
            return
        qfull = torch.cat([torch.zeros((B, pos, H, dh)),
                           torch.from_numpy(q)], dim=1)
        dense = layers._dense_attention(
            qfull, torch.from_numpy(kc[:, :pos + 1]),
            torch.from_numpy(vc[:, :pos + 1]), causal=True, window=0,
            logit_cap=20.0, q_offset=0)
        np.testing.assert_allclose(out[:, 0].numpy(), dense[:, -1].numpy(),
                                   rtol=2e-4, atol=2e-4)

    def test_cache_insert_ring_slot_and_clamp(self):
        """The ring slot is pos % S with a window; a position past a plain
        cache is clamped to its last slot, as dynamic_update_slice does."""
        for window, pos in ((8, 13), (0, 5), (0, 99)):
            cache = np.zeros((1, 8, 1, 2), np.float32)
            new = np.full((1, 1, 1, 2), 7.0, np.float32)
            want = np.asarray(jlayers.cache_insert(
                jnp.asarray(cache), jnp.asarray(new), jnp.int32(pos),
                window))
            got = layers.cache_insert(torch.from_numpy(cache),
                                      torch.from_numpy(new), pos, window)
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_count_all_architectures_full_size(name):
    cfg, tcfg = get_config(name), tbase.get_config(name)
    assert tcfg == tbase.ArchConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    assert M.param_count(tcfg) == JM.param_count(cfg)
    assert M.active_param_count(tcfg) == JM.active_param_count(cfg)
    for B, S_ in ((2, 64), (4, 5120)):
        want = jax.tree_util.tree_leaves(
            JT.cache_tree(cfg, B, S_),
            is_leaf=lambda x: type(x).__name__ == "PD")
        got = P.leaves(T.cache_tree(tcfg, B, S_))
        assert [tuple(g) for g in got] == [tuple(w) for w in want]


def _as_tuples(spec):
    """A ``PartitionSpec`` as the port's tuple of per-dimension tuples:
    the installed jax gives a one-axis entry as the bare name."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


class _Mesh:
    """A mesh stand-in: all ``resolve_pspec`` reads is ``.shape``."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh", [{"pod": 2, "data": 16, "model": 16},
                                  {"data": 8, "model": 4}])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_resolve_pspec_every_leaf_all_architectures(name, mesh):
    """Every parameter leaf's spec, for the ten full configurations, equals
    the reference's ``PartitionSpec`` as a tuple."""
    cfg, tcfg = get_config(name), tbase.get_config(name)
    want = jax.tree_util.tree_leaves(
        JM.param_pspecs(cfg, _Mesh(mesh)),
        is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
    got = P.leaves(M.param_pspecs(tcfg, _Mesh(mesh)))
    assert len(got) == len(want) > 0
    assert got == [_as_tuples(w) for w in want]
    pd = P.leaves(T.param_tree(tcfg))[0]
    assert tshd.resolve_pspec(pd.shape, pd.axes, _Mesh(mesh)) == _as_tuples(
        jshd.resolve_pspec(pd.shape, pd.axes, _Mesh(mesh)))


def test_shard_is_the_identity_and_set_mesh_keeps_rules():
    x = torch.ones(3, 4)
    assert tshd.shard(x, "act_batch", None) is x
    tshd.set_mesh(_Mesh({"model": 2}), rules={"embed": None})
    try:
        assert tshd.get_rules()["embed"] is None
        assert tshd.get_mesh().shape == {"model": 2}
    finally:
        tshd.set_mesh(None)
    assert tshd.get_rules() == tshd.DEFAULT_RULES


def test_init_params_draws_the_reference_inits():
    """Scaled normals (1/sqrt(fan_in)), zeros and ones, in the requested
    dtype, reproducible from the generator's seed."""
    _, tcfg = _configs("qwen25_32b")
    a = M.init_params(tcfg, torch.Generator().manual_seed(3))
    b = M.init_params(tcfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(P.leaves(a), P.leaves(b)))
    assert a["embed"].dtype == torch.bfloat16
    assert not a["final_norm"].any() and not a["layers"]["wq"]["b"].any()
    std = float(a["layers"]["wg"].float().std())
    assert abs(std - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5
    cache = M.init_cache(tcfg, 2, 16)
    assert not cache["layers"]["k"].any()
    assert tuple(cache["layers"]["k"].shape) == (2, 2, 16, 4, 32)
