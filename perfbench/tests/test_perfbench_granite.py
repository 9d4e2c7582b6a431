"""The compressed training cell at a tiny size on the CPU: ``correct``
holds for the program, and fails for the control (the reference with its
matrix products' inputs rounded to float8) and for each planted fault:
the error feedback left unchanged, half the batch replaced, an update
value altered where it is produced.  Also the FLOP count's terms and the
any-thread range reader."""
from __future__ import annotations

import pytest
import torch

from perfbench import flops, harness
from perfbench.chrometrace import Trace
from perfbench.readers import range_ms_step

CELL = "granite4h_small.compressed_train"
QUIET = {"log": lambda *a, **k: None}


def faulty(step, fault: str):
    def run(state, batch):
        if fault == "half":
            t = batch["tokens"].clone()
            t[1:] = t[:1]
            batch = dict(batch, tokens=t)
        new, m = step(state, batch)
        if fault == "unchanged":
            new = new._replace(error=state.error)
        if fault == "altered":
            name = sorted(m["update"]["mamba"])[0]
            sp = m["update"]["mamba"][name].reshape(-1)
            i = int(torch.nonzero(sp)[0])
            sp[i] = sp[i] * 1.5
        return new, m

    return run


def test_the_program_is_correct(tiny_root):
    r = harness.run(tiny_root, CELL, 2**33 + 9, 0.2, False, device="cpu",
                    **QUIET)
    assert r["correct"], r["checks"]
    assert r["checks"]["moe_dropped"]["value"] == 0


def test_the_control_is_not_correct(tiny_root):
    r = harness.run(tiny_root, CELL, 19, 0.2, False, device="cpu",
                    program="control", **QUIET)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_a_planted_fault_is_not_correct(tiny_root, fault):
    r = harness.run(tiny_root, CELL, 29, 0.2, False, device="cpu",
                    program=lambda step: faulty(step, fault), **QUIET)
    assert not r["correct"], (fault, r["checks"])


def test_flops_count_the_routed_choices_and_causal_halves():
    hf = {"hidden_size": 8, "mamba_n_heads": 2, "mamba_d_head": 4,
          "mamba_n_groups": 1, "mamba_d_state": 2, "mamba_chunk_size": 4,
          "mamba_d_conv": 4, "intermediate_size": 3,
          "shared_intermediate_size": 5, "num_experts_total": 6,
          "num_attention_heads": 2, "num_key_value_heads": 1,
          "layer_types": ["attention"], "num_hidden_layers": 1,
          "vocab_size": 7}
    T, S, D = 8, 8, 8
    attn = 2 * T * D * 4 * 4 + 2 * 1 * S * S * 2 * 4 + 2 * T * 8 * D
    moe = 2 * T * D * 6 + 6 * T * D * 5 + 6 * 10 * D * 3
    assert flops.forward_flops(hf, 1, S, routed=10) \
        == attn + moe + 2 * T * D * 7
    assert flops.train_step_flops(hf, 1, S, 10) \
        == 3 * flops.forward_flops(hf, 1, S, 10)


def test_range_ms_step_counts_every_thread_once_per_step():
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "tid": t,
           "ts": a, "dur": d} for n, t, a, d in (
               ("bench.step", 1, 0, 1000), ("train.grad", 1, 10, 500),
               ("bench.step", 1, 2000, 1000), ("train.grad", 1, 2010, 500))]
    for corr, (tid, ts) in enumerate([(1, 20), (2, 300), (2, 2100),
                                      (1, 900)]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "tid": tid, "ts": ts, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": ts + 5,
                   "dur": 100, "args": {"correlation": corr}})
    tr = Trace(ev)
    got = range_ms_step.read(tr, None, {}, {"range": "train.grad",
                                            "per": "bench.step"})
    assert got == pytest.approx(3 * 100e-3 / 2)
