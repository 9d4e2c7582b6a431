"""The ``range_idle`` reader on synthetic traces: the window's idle gaps
inside a named range's host spans on the window's thread, per instance."""
from __future__ import annotations

import pytest

from perfbench.chrometrace import Trace
from perfbench.readers import range_idle


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def _kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def _read(events, name):
    tr = Trace(events)
    return range_idle.read(tr, tr.window("bench.window"), {},
                           {"range": name})


# the device runs 0-100, 300-400 and 800-1000 of a 1000 us window: idle
# 100-300 and 400-800
DEVICE = [_kernel(0, 100, 1), _kernel(300, 100, 2), _kernel(800, 200, 3)]


def test_a_gap_inside_nested_spans_counts_once():
    ev = [_span("bench.window", 0, 1000),
          _span("engine.sample", 50, 400),        # 50-450
          _span("sample.estimate", 120, 100),     # nested, same gap
          _span("engine.sample", 150, 100)] + DEVICE  # nested in itself
    # idle inside 50-450: 100-300 and 400-450, 250 us, over 2 instances
    assert _read(ev, "engine.sample") == pytest.approx(250e-3 / 2)
    assert _read(ev, "sample.estimate") == pytest.approx(100e-3)


def test_another_threads_span_is_not_counted():
    ev = [_span("bench.window", 0, 1000),
          _span("gradcomp.step", 420, 100),                # all idle
          _span("gradcomp.step", 100, 700, tid=2)] + DEVICE
    assert _read(ev, "gradcomp.step") == pytest.approx(100e-3)


def test_a_range_with_no_span_reads_none():
    ev = [_span("bench.window", 0, 1000),
          _span("gradcomp.step", 100, 700, tid=2)] + DEVICE
    assert _read(ev, "gradcomp.step") is None
    assert _read(ev, "engine.sample") is None


def test_a_window_with_no_device_activity_reads_none():
    """A CPU run's trace holds no device time: no device metric."""
    ev = [_span("bench.window", 0, 1000), _span("engine.sample", 50, 400)]
    assert _read(ev, "engine.sample") is None
