"""The hybrid_moe family (granite-4.0-h-small) against its plain reference
(``tests/granite_hybrid_ref.py``), on the CPU at a tiny size: one period
of 10 layers (9 Mamba-2, attention at 5), tiny widths, seeded random
weights in float32 (every leaf drawn, norms and biases included).

Tolerances: loss and gradients rtol 2e-4 of each leaf's largest gradient
(float32 both; the program's SSD chunks 128 tokens where the reference's
chunk 256, and its attention is PyTorch's fused kernel: sums in other
orders).  The routing is compared exactly (the same experts chosen and
counted), and no choice is dropped."""
import dataclasses

import pytest
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import get_config
from repro_torch.distributed import pytree
from repro_torch.models import hybrid_moe, moe
from repro_torch.models import model as M
from repro_torch.train import steps

from granite_hybrid_ref import Reference, hf_config

TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _no_recompute(monkeypatch):
    """Layers run once: ``layer_call`` imports ``checkpoint`` as it
    calls, so the patch takes effect."""
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **k: fn(*a))


def tiny(**kw):
    return dataclasses.replace(get_config("granite_4_0_h_small").reduced(),
                               **kw)


def random_params(cfg, seed=0):
    """Every leaf drawn: the init's normals, norms near 1, biases and the
    SSM's A_log, D and dt_bias spread around theirs."""
    g = torch.Generator().manual_seed(seed)
    p = M.init_params(cfg, g, dtype=torch.float32)
    return pytree.tree_map(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=g), p)


def batch(cfg, S=512, B=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


def test_param_tree_of_the_cut_is_the_published_share():
    """The benchmark's cut: one period, 8 of 72 experts, 12,544 ids."""
    cfg = dataclasses.replace(get_config("granite-4.0-h-small"),
                              num_layers=10, experts_held=8,
                              vocab_size=12544)
    tree = M.T.param_tree(cfg)
    assert M.param_count(cfg) == 1_960_659_584
    assert len(M.P.leaves(tree)) == 32
    assert tree["mamba"]["in_proj"].shape == (9, 4096, 16768)
    assert tree["attn"]["router"].shape == (1, 4096, 72)
    assert tree["attn"]["moe_wg"].shape == (1, 8, 4096, 768)


def test_loss_and_gradients_match_the_reference():
    cfg = tiny()
    params, b = random_params(cfg), batch(cfg)
    with moe.count_routes() as routes, moe.count_drops() as drops:
        loss, grads = steps.value_and_grad(params, b, cfg)
    ref = Reference(hf_config(cfg))
    rloss, rgrads = ref.loss_and_grads(params, b["tokens"], b["labels"])
    _close(loss, rloss, "loss")
    for i, (got, want) in enumerate(zip(pytree.leaves(grads),
                                        pytree.leaves(rgrads))):
        _close(got, want, i)
    # one count a layer (the recomputation counts nothing); none dropped
    assert len(routes) == len(drops) == cfg.num_layers
    assert sum(int(d) for d, _ in drops) == 0
    assert all(int(c.sum()) <= b["tokens"].numel() * cfg.moe_top_k
               for c in routes)


def test_routed_counts_match_the_reference():
    cfg = tiny()
    params, b = random_params(cfg, 2), batch(cfg, S=128)
    ref = Reference(hf_config(cfg))
    x = ref.embed(params, b["tokens"])
    for kind, p in ref.layers(params):
        m = cfg.residual_multiplier
        with torch.no_grad():
            xn = ref.rmsnorm(x, p["ln1"])
            h = x + m * (ref.mamba(xn, p) if kind == "mamba"
                         else ref.attention(xn, p))
            hn = ref.rmsnorm(h, p["ln2"])
            _, want = ref.moe(hn, p)
            mp = {"router": p["router"], "wg": p["moe_wg"],
                  "wi": p["moe_wi"], "wo": p["moe_wo"]}
            with moe.count_routes() as got:
                moe.moe_held(hn, mp, cfg.moe_top_k, 0, cfg.held_experts)
            assert got[0].tolist() == want
            x = ref.layer(x, p, kind)


def test_drops_count_held_choices_past_the_rows(monkeypatch):
    """``count_drops`` reads the choices: a router that repeats a held
    expert in a token's choices (which top-k never does) holds more
    choices than the T * min(K, held) rows, and the surplus is counted."""
    T, D, F, E, held, K = 6, 8, 4, 6, 2, 4
    g = torch.Generator().manual_seed(7)
    x = torch.randn(1, T, D, generator=g)
    mp = {"router": torch.randn(D, E, generator=g),
          "wg": torch.randn(held, D, F, generator=g),
          "wi": torch.randn(held, D, F, generator=g),
          "wo": torch.randn(held, F, D, generator=g)}
    with moe.count_drops() as drops:
        moe.moe_held(x, mp, K, 0, held)
    assert int(drops[0][0]) == 0
    monkeypatch.setattr(moe.worp, "top_k", lambda logits, k: (
        logits[:, :k], torch.zeros(logits.shape[0], k, dtype=torch.int64)))
    with moe.count_drops() as drops:
        moe.moe_held(x, mp, K, 0, held)
    assert int(drops[0][0]) == T * K - T * min(K, held)


def test_expert_shares_sum_to_the_uncut_layer():
    """9 chips of 2 experts each (18 in all): the shares' layer outputs,
    with what every chip computes alike (the mixer, the residuals, the
    shared expert) counted once, add up to the uncut reference layer."""
    E, held, shares = 18, 2, 9
    full = tiny(num_experts=E, moe_top_k=4, experts_held=E)
    params = random_params(full, 3)
    x = torch.randn(2, 128, full.d_model,
                    generator=torch.Generator().manual_seed(4))
    ref = Reference(hf_config(full))
    for kind in ("mamba", "attention"):
        stack = params["mamba" if kind == "mamba" else "attn"]
        lp = hybrid_moe._index(stack, 0)
        with torch.no_grad():
            want = ref.layer(x, lp, kind)

            def share(offset, n):
                cfg = dataclasses.replace(full, expert_offset=offset,
                                          experts_held=n)
                # past the last expert the weights are never read
                at = offset if offset < E else 0
                part = dict(lp, **{k: lp[k][at:at + n] for k in
                                   ("moe_wg", "moe_wi", "moe_wo")})
                return hybrid_moe.layer(x, part, cfg, kind)

            common = share(E, held)  # holds no expert: the common part
            got = common + sum(share(s * held, held) - common
                               for s in range(shares))
        _close(got, want, kind)


def test_recomputation_leaves_the_gradients_unchanged(monkeypatch):
    """With and without recomputation: every gradient the same bits, but
    the tied embedding's, whose two parts (the lookup's and the logits')
    autograd adds in another order: within a float32 rounding of them."""
    cfg = tiny()
    params, b = random_params(cfg, 5), batch(cfg, S=256)
    loss1, g1 = steps.value_and_grad(params, b, cfg)
    _no_recompute(monkeypatch)
    loss2, g2 = steps.value_and_grad(params, b, cfg)
    assert torch.equal(loss1, loss2)
    for name in g1:
        for x, y in zip(pytree.leaves(g1[name]), pytree.leaves(g2[name])):
            if name == "embed":
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
            else:
                assert torch.equal(x, y), name


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mamba2_13b",
                                  "recurrentgemma_9b"])
def test_every_family_recomputes_with_the_same_gradients(arch,
                                                        monkeypatch):
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, g, dtype=torch.float32)
    b = batch(cfg, S=64, seed=6)
    loss1, g1 = steps.value_and_grad(params, b, cfg)
    _no_recompute(monkeypatch)
    loss2, g2 = steps.value_and_grad(params, b, cfg)
    assert torch.equal(loss1, loss2)
    for x, y in zip(pytree.leaves(g1), pytree.leaves(g2)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)


def test_adamw_in_place_equals_update_bit_for_bit(monkeypatch):
    from repro_torch.optim import adamw

    monkeypatch.setattr(adamw, "_CHUNK", 100)
    g = torch.Generator().manual_seed(7)
    params = {"a": torch.randn(33, 17, generator=g).to(torch.bfloat16),
              "b": torch.randn(250, generator=g)}
    ours = pytree.tree_map(torch.clone, params)
    st, st_ = adamw.init(params), adamw.init(ours)
    for _ in range(3):
        grads = pytree.tree_map(
            lambda p: torch.randn(p.shape, generator=g), params)
        params, st = adamw.update(params, grads, st, lr=1e-2)
        st_ = adamw.update_(ours, grads, st_, lr=1e-2)
        for x, y in zip(pytree.leaves((params, st.mu, st.nu)),
                        pytree.leaves((ours, st_.mu, st_.nu))):
            assert torch.equal(x, y)
        assert torch.equal(st.step, st_.step)


def test_engine_compressed_step_is_compression_then_adamw(tmp_path):
    """The engine step is the engine compressor on the step's gradients,
    then AdamW from its sparse update, the error carried; through
    ``run_training`` it trains the hybrid."""
    import torch.distributed as dist

    from repro_torch.optim import adamw, gradcomp
    from repro_torch.train import loop

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        cfg = tiny()
        cc = gradcomp.CompressorConfig(width=256)
        params, b = random_params(cfg, 8), batch(cfg, S=128)
        st = steps.CompressedTrainState(
            params=pytree.tree_map(torch.clone, params),
            opt=adamw.init(params), error=gradcomp.init_error(params))
        step = steps.make_compressed_train_step_engine(cfg, None, cc,
                                                       expose=True)
        new, m = step(st, b)
        _, grads = steps.value_and_grad(params, b, cfg)
        sparse, err, _ = gradcomp.tree_compress_step_engine(
            grads, gradcomp.init_error(params), cc, None)
        want, _ = adamw.update(params, sparse, adamw.init(params))
        for x, y in zip(pytree.leaves((new.params, new.error, m["update"])),
                        pytree.leaves((want, err, sparse))):
            assert torch.equal(x, y)
        out = loop.run_training(cfg, num_steps=2, batch=2, seq=128,
                                compressed=True, compressor="engine",
                                device="cpu", print_fn=lambda s: None)
        assert all(torch.isfinite(torch.tensor(out["losses"])))
    finally:
        dist.destroy_process_group()


def test_the_benchmarks_reference_is_this_reference():
    """``perfbench/reference/granite_hybrid.py`` is a copy of this
    reference, byte for byte."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    assert (here.parent / "perfbench" / "reference" / "granite_hybrid.py"
            ).read_bytes() == (here / "granite_hybrid_ref.py").read_bytes()
