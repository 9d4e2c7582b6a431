"""``correct`` comes out true for the program and false for the control
and for every fault a cell can have, each planted under a full run of the
harness (its look for a chip skipped) at a tiny size on the CPU.

The faults: a step that returns its state unchanged; half of the batch
left out, the rest doubled so the mean holds; an answer altered where it
is produced.  No cell exchanges anything between chips (one rank), so the
fault of a left-out exchange has no place to be planted."""
from __future__ import annotations

import pytest
import torch

from perfbench import harness

CELLS = ("tenants4096.device_stream", "phi4mini_grad.engine_dense",
         "phi4mini_grad.gradcomp_step")
FAULTS = ("unchanged", "half", "altered")


class FaultyEngine:
    """A ``SketchEngine`` with one fault planted."""

    def __init__(self, eng, fault: str):
        self.eng, self.fault = eng, fault

    def __getattr__(self, name):
        return getattr(self.eng, name)

    @property
    def state(self):
        return self.eng.state

    def update(self, keys, values):
        if self.fault == "unchanged":
            return self
        if self.fault == "half":
            half = keys.shape[1] // 2
            keys, values = keys[:, :half], values[:, :half] * 2
        self.eng.update(keys, values)
        return self

    def update_dense(self, values, lengths=None):
        if self.fault == "unchanged":
            return self
        if self.fault == "half":
            values = values.clone()
            values[:, values.shape[1] // 2:] = 0
            values *= 2
        self.eng.update_dense(values, lengths=lengths)
        return self

    def sample(self, k):
        s = self.eng.sample(k)
        if self.fault != "altered":
            return s
        keys = s.keys.clone()
        keys[0, 0] = keys[0, 0] + 1
        return s._replace(keys=keys)


def faulty_step(step, fault: str):
    """``tree_compress_step_engine`` with one fault planted."""

    def run(grads, error, cc, group=None, **kw):
        if fault == "half":
            grads = {k: torch.where(torch.arange(g.numel()).reshape(g.shape)
                                    % 2 == 0, 2 * g, 0.0)
                     for k, g in grads.items()}
        sparse, new_err, stats = step(grads, error, cc, group, **kw)
        if fault == "unchanged":
            new_err = error
        if fault == "altered":
            name = sorted(sparse)[0]
            sp = sparse[name].clone().reshape(-1)
            i = int(torch.nonzero(sp)[0])
            sp[i] = sp[i] * 1.5
            sparse = dict(sparse, **{name: sp.reshape(sparse[name].shape)})
        return sparse, new_err, stats

    return run


def planted(cell: str, fault: str):
    if cell.endswith("gradcomp_step"):
        return lambda step: faulty_step(step, fault)
    return lambda eng: FaultyEngine(eng, fault)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(tiny_root, cell):
    r = harness.run(tiny_root, cell, 2**33 + 5, 0.2, False, device="cpu",
                    log=lambda *a, **k: None)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    r = harness.run(tiny_root, cell, 17, 0.2, False, device="cpu",
                    program="control", log=lambda *a, **k: None)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    r = harness.run(tiny_root, cell, 23, 0.2, False, device="cpu",
                    program=planted(cell, fault), log=lambda *a, **k: None)
    assert not r["correct"], (fault, r["checks"])
