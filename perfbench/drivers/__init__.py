"""Drivers: one module a kind of work, named by a traffic file's
``"driver"``.  Each module's ``Driver(config, traffic, seed, device,
program)`` builds its inputs and the program in ``setup()``, runs one
closed-loop cycle a ``cycle()`` call, and after ``release()`` (the
program's state freed, its outputs kept) works out ``checks()`` against the
plain reference.

``program`` is ``"port"`` (the system under test), ``"control"`` (the
reference at the next lower precision, in the program's place), or a
callable that wraps the port's program (a planted fault, in tests)."""
from __future__ import annotations

import random
import time

import torch


class Reservoir:
    """Which of a stream of offers to keep: ``size`` of them, uniformly,
    from a generator seeded by the run's seed (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept: dict = {}

    def offer(self) -> int | None:
        """The slot an offer is kept in, or None."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.size:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.size else None


class Base:
    """Window accounting shared by the drivers."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program="port"):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.program = program
        self.reservoir = Reservoir(int(traffic.get("checked", 1)),
                                   self.seed)
        self.checkpoints: dict = {}
        self.in_window = False
        self.input_bytes = 0
        self.input_peak = 0

    def inputs_made(self, *tensors):
        """Note the bytes of the inputs set-up has drawn, and start the
        device's peak afresh, so that the run's peak less these bytes is
        the program's own memory."""
        self.input_bytes = sum(t.numel() * t.element_size() for t in tensors)
        if self.device.type == "cuda":
            self.input_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self):
        self.sync()
        self.in_window = True
        self.window_ops = 0
        self.t0 = time.perf_counter()

    def end_window(self) -> float:
        self.sync()
        self.in_window = False
        return time.perf_counter() - self.t0

    def close(self):
        """Stop whatever the driver started (threads, process groups)."""
