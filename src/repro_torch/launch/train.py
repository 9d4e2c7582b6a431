"""Training launcher (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_13b \
        --steps 100 --reduced --device cpu [--compressed] [--ckpt DIR]

The reference's flags, plus ``--device`` (the card unless the caller asks
otherwise).  ``--reduced`` runs the small configuration; without it the
published one.  ``--compressed`` trains with WORp-compressed gradients
(``gradcomp.CompressorConfig()``; ``--compressor engine`` through the
per-leaf engine path, one WOR sample a leaf, with AdamW in place; the
default ``flat`` one sample of the raveled gradient) over the default
process group when one
is initialised; otherwise over one built from torchrun's environment when
``WORLD_SIZE`` is set (``nccl`` on the card, ``gloo`` on the CPU); failing
both, over a one-rank group of that backend meeting through a
``FileStore`` in a temporary directory.  A group the launcher built is
torn down when it returns.  ``main`` returns ``run_training``'s dict.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from repro_torch.configs.base import ARCH_NAMES, PORT_ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.optim import gradcomp
from repro_torch.train import loop


@contextlib.contextmanager
def process_group(dev: torch.device):
    """The default process group for a compressed run: the one already
    initialised, else one from torchrun's environment (``WORLD_SIZE``),
    else a one-rank group through a ``FileStore``; a group built here is
    destroyed on exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    choices=ARCH_NAMES + PORT_ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compressed", action="store_true",
                    help="WORp-compressed DP gradients")
    ap.add_argument("--compressor", choices=("flat", "engine"),
                    default="flat",
                    help="the compressed step's compressor (--compressed)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card; 'cpu' "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    cc = gradcomp.CompressorConfig() if args.compressed else None
    group = process_group(dev) if args.compressed \
        else contextlib.nullcontext()
    with group:
        out = loop.run_training(
            cfg, num_steps=args.steps, batch=args.batch, seq=args.seq,
            lr=args.lr, ckpt_dir=args.ckpt, compressed=args.compressed,
            cc=cc, compressor=args.compressor, device=dev)
    print(f"done: final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
