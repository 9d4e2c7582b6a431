"""Device-idle milliseconds per instance of a named range
(``params["range"]``): the window's idle gaps that fall inside the range's
host spans on the window's thread, each stretch counted once however the
spans nest, summed and divided by the instances there."""


def _union(spans):
    out = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return out


def read(trace, window, facts, params):
    if window is None:
        return None
    spans = [s for s in trace.spans(params["range"]) if s.tid == window.tid]
    busy, gaps = trace.busy(window)
    if not spans or busy <= 0:
        return None
    idle = sum(max(0.0, min(e, hi) - max(s, lo))
               for lo, hi in _union(spans) for s, e in gaps)
    return idle * 1e-3 / len(spans)
