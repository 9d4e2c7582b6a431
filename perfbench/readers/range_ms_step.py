"""Device milliseconds a step of a named range (``params["range"]``):
every activity launched inside any of its spans, on any thread (autograd
launches a backward from its own device thread, and a layer recomputed
there opens its spans on that thread), each counted once, over the
instances of ``params["per"]`` (the driver's step range)."""


def read(trace, window, facts, params):
    spans, per = trace.spans(params["range"]), trace.spans(params["per"])
    if not spans or not per:
        return None
    import bisect

    ts = trace._launch_ts
    corr = set()
    for s in spans:
        lo = bisect.bisect_left(ts, s.start)
        hi = bisect.bisect_right(ts, s.end)
        corr.update(c for _, _, c in trace.launches[lo:hi])
    acts = [a for c in corr for a in trace._by_corr.get(c, ())]
    if not acts:
        return None
    return sum(a.end - a.start for a in acts) * 1e-3 / len(per)
