"""Named host ranges of the program, for ``torch.profiler``.

``span(name)`` is the program's one way to mark a stage.  While a profiler
collects (``torch.profiler.profile`` in its recording phase,
``torch.autograd.profiler.profile``, ``emit_nvtx``, ``emit_itt``) it enters
``torch.profiler.record_function(name)``, so the range lands in the trace
beside the device activities it launched; otherwise it returns one shared
no-op context, with no RecordFunction and nothing allocated.  The test is
PyTorch's own process-wide flag, which every profiler sets on start and
clears on stop, so a worker thread's spans follow the profiler too.

A span marks a stage, once a call: never inside a per-leaf, per-row or
per-stream loop.  A model's layers are the one exception: a span a layer
(``layer.*``, ``ssd.scan``, ``moe.*``, ten or so of each a step, each
opened again where backward recomputes the layer), whose work is
milliseconds, against the 10.7 us a span costs while a profiler runs.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``name`` while a profiler collects,
    and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


__all__ = ["span"]
