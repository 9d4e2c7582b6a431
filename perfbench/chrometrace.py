"""Reading a ``torch.profiler`` trace (its Chrome trace JSON).

A named range's device time is the sum of every device activity (kernel,
copy, fill) whose launch lies inside one of the range's host spans on the
range's thread: the launch is the runtime call (``cuda_runtime`` or
``cuda_driver``) with the activity's CUPTI correlation id.  So kernels that
the program launches through ctypes count as PyTorch's own do, which a
profiler's per-operator totals leave out.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation",)


class Span(NamedTuple):
    name: str
    tid: object
    start: float  # microseconds
    end: float


class Activity(NamedTuple):
    name: str
    start: float
    end: float
    correlation: int


class Trace:
    def __init__(self, events: list):
        self.ranges: dict = defaultdict(list)
        self.launches: list = []      # (tid, ts, correlation), sorted by ts
        self.activities: list = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in RANGE_CATS:
                self.ranges[e["name"]].append(
                    Span(e["name"], e.get("tid"), ts, ts + dur))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches.append((e.get("tid"), ts,
                                      int(args["correlation"])))
            elif cat in DEVICE_CATS:
                self.activities.append(Activity(
                    e.get("name", cat), ts, ts + dur,
                    int(args.get("correlation", -1))))
        self.launches.sort(key=lambda x: x[1])
        self._launch_ts = [x[1] for x in self.launches]
        self._launch_tids = {x[0] for x in self.launches}
        self._by_corr: dict = defaultdict(list)
        for a in self.activities:
            self._by_corr[a.correlation].append(a)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", data) if isinstance(data, dict)
                   else data)

    def spans(self, name: str) -> list:
        return self.ranges.get(name, [])

    def launched_in(self, span: Span) -> list:
        """The device activities launched inside one host span: on the
        span's thread where the trace's launches carry that thread, else on
        any thread."""
        lo = bisect.bisect_left(self._launch_ts, span.start)
        hi = bisect.bisect_right(self._launch_ts, span.end)
        same = span.tid in self._launch_tids
        out = []
        for tid, _, corr in self.launches[lo:hi]:
            if not same or tid == span.tid:
                out.extend(self._by_corr.get(corr, ()))
        return out

    def range_device(self, name: str):
        """(instances, device seconds, activities) of every span of the
        named range, or None where the trace holds no such span."""
        spans = self.spans(name)
        if not spans:
            return None
        acts = [a for s in spans for a in self.launched_in(s)]
        return len(spans), sum(a.end - a.start for a in acts) * 1e-6, acts

    def window(self, name: str) -> Span | None:
        spans = self.spans(name)
        return spans[0] if spans else None

    def busy(self, window: Span) -> tuple[float, list]:
        """Seconds in which some device activity ran inside the window (the
        union of their intervals), and the idle gaps as (start, end)."""
        ivs = sorted((max(a.start, window.start), min(a.end, window.end))
                     for a in self.activities
                     if a.end > window.start and a.start < window.end)
        busy, gaps, cur = 0.0, [], window.start
        for s, e in ivs:
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if window.end > cur:
            gaps.append((cur, window.end))
        return busy * 1e-6, gaps

    def breakdown(self, window: Span, gaps: list, top: int = 10) -> dict:
        """The device operations that took most time in the window, and the
        idle gaps summed by the innermost host range around each gap's
        middle (``host`` outside every range but the window's)."""
        ops: dict = defaultdict(float)
        for a in self.activities:
            if a.end > window.start and a.start < window.end:
                ops[a.name] += (min(a.end, window.end)
                                - max(a.start, window.start)) * 1e-6
        spans = [s for v in self.ranges.values() for s in v
                 if s.tid == window.tid and s is not window
                 and s.name != window.name]
        idle: dict = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) / 2
            inner = [x for x in spans if x.start <= mid <= x.end]
            name = min(inner, key=lambda x: x.end - x.start).name \
                if inner else "host"
            idle[name] += (e - s) * 1e-6
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gaps_by]}
