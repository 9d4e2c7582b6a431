"""Serving example on the PyTorch port: prefill a batch of prompts, then
batched greedy decode steps.

    PYTHONPATH=src python examples/torch_serve_example.py [--device cpu]

The port's twin of ``examples/serve_example.py``: the reduced mamba2
(attention-free: an O(1) decode state), its weights drawn from a
``torch.Generator`` (seed 0; ``jax.random`` cannot be reproduced, so they
are not the reference's), 4 prompts of 64 tokens (seed 1), a prefill and
16 greedy decode steps.  ``generate`` takes any weights, so a reference
model's cross over through ``repro_torch.convert.params_from_numpy``.
Runs on the card unless ``--device`` says otherwise.
"""
import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.distributed import pytree
from repro_torch.launch.serve import greedy
from repro_torch.models import model as M
from repro_torch.train import steps

B, S = 4, 64


def generate(cfg, params, prompts: torch.Tensor, n_tokens: int):
    """Prefill ``prompts`` (B, S), then ``n_tokens`` greedy decode steps:
    (prefill logits, number of state leaves, (B, 1 + n_tokens) ids)."""
    logits, cache = steps.serve_prefill(params, {"tokens": prompts}, cfg)
    tok = greedy(logits[:, -1:])
    generated = [tok]
    S_ = prompts.shape[1]
    for i in range(n_tokens):
        lg, cache = steps.serve_step(
            params, {"token": tok, "pos": S_ + i, "cache": cache}, cfg)
        tok = greedy(lg)
        generated.append(tok)
    return logits, len(pytree.leaves(cache)), torch.cat(generated, dim=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("mamba2_13b").reduced()  # attention-free decode state
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    logits, leaves, gen = generate(cfg, params, prompts, args.tokens)
    print(f"prefill: logits {tuple(logits.shape)}, state leaves {leaves}")
    ids = gen.cpu().tolist()
    print("greedy continuations (token ids):")
    for row in ids:
        print(" ", row)
    finite = bool(torch.isfinite(logits.float()).all())
    print(f"prefill logits finite: {finite}")
    return {"device": str(dev), "logits_shape": tuple(logits.shape),
            "state_leaves": leaves, "ids": ids, "finite": finite}


if __name__ == "__main__":
    main()
