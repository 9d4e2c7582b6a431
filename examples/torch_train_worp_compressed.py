"""End-to-end driver on the PyTorch port: train a ~few-M-param LM for a few
hundred steps with WORp-compressed data-parallel gradients, with
checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_worp_compressed.py \
        [--steps 200] [--device cpu]

On the CPU it spawns 4 data-parallel ranks (``gloo``, meeting through a
``FileStore``), each training on its own rows of every batch; on the card
(the default) one rank over ``nccl``.  The only gradient collective is the
sketch all-reduce (+ 2k floats of pass-II exact values).  Rank 0 writes the
checkpoints; run it again to resume from the last one.  ``main`` joins the
ranks within ``--timeout`` seconds (and kills any left) and returns what
rank 0 printed: the final loss, the losses of the steps it ran and the
stragglers flagged; and rank 0's kernel launches.
"""
import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.optim import gradcomp
from repro_torch.train import loop

CPU_RANKS = 4
ARCH = "gemma2_2b"  # reduced
BATCH, SEQ, LR = 8, 128, 1e-3
CC = dict(k=512, rows=7, width=4096, candidates=1024, p=1.0, mode="twopass")


def train(rank: int, world: int, store: str, result: str, args) -> None:
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        say = print if rank == 0 else (lambda s: None)
        out = loop.run_training(
            get_config(ARCH).reduced(), num_steps=args.steps, batch=BATCH,
            seq=SEQ, lr=LR, ckpt_dir=args.ckpt, ckpt_every=50,
            compressed=True, cc=gradcomp.CompressorConfig(**CC),
            log_every=20, print_fn=say, device=dev)
        say(f"final loss: {out['final_loss']:.4f} (dense-equivalent comm "
            f"ratio: see benchmarks/gradcomp_comm.py)")
        say(f"stragglers flagged: {len(out['stragglers'])}")
        if rank == 0:
            with open(result, "w") as f:
                json.dump({"final_loss": out["final_loss"],
                           "losses": out["losses"],
                           "stragglers": len(out["stragglers"]),
                           "launches": launch_counts()}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "worp_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="default: the card, one rank; 'cpu': "
                         f"{CPU_RANKS} gloo ranks")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds to wait for the ranks")
    args = ap.parse_args(argv)
    world = CPU_RANKS if resolve_device(args.device).type == "cpu" else 1
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        ctx = mp.start_processes(
            train, args=(world, os.path.join(tmp, "store"), result, args),
            nprocs=world, start_method="spawn", join=False)
        deadline = time.monotonic() + args.timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the {world} ranks did not finish "
                                       f"within {args.timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        with open(result) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
