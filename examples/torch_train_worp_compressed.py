"""End-to-end driver on the PyTorch port: train a ~few-M-param LM for a few
hundred steps with WORp-compressed data-parallel gradients, with
checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_worp_compressed.py \
        [--steps 200] [--device cpu]

On the CPU it spawns 4 data-parallel ranks (``gloo``, meeting through a
``FileStore``), each training on its own rows of every batch; on the card
(the default) one rank over ``nccl``.  The only gradient collective is the
sketch all-reduce (+ 2k floats of pass-II exact values).  Rank 0 writes the
checkpoints; run it again to resume from the last one.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.optim import gradcomp
from repro_torch.train import loop

CPU_RANKS = 4


def train(rank: int, world: int, store: str, args) -> None:
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        cfg = get_config("gemma2_2b").reduced()
        cc = gradcomp.CompressorConfig(k=512, rows=7, width=4096,
                                       candidates=1024, p=1.0,
                                       mode="twopass")
        say = print if rank == 0 else (lambda s: None)
        out = loop.run_training(
            cfg, num_steps=args.steps, batch=8, seq=128, lr=1e-3,
            ckpt_dir=args.ckpt, ckpt_every=50, compressed=True, cc=cc,
            log_every=20, print_fn=say, device=dev)
        say(f"final loss: {out['final_loss']:.4f} (dense-equivalent comm "
            f"ratio: see benchmarks/gradcomp_comm.py)")
        say(f"stragglers flagged: {len(out['stragglers'])}")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "worp_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="default: the card, one rank; 'cpu': "
                         f"{CPU_RANKS} gloo ranks")
    args = ap.parse_args()
    world = CPU_RANKS if resolve_device(args.device).type == "cpu" else 1
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(train, args=(world, os.path.join(tmp, "store"),
                                        args),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
