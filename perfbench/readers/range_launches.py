"""Device operations (kernels, copies, fills) launched per instance of a
named range (``params["range"]``)."""


def read(trace, window, facts, params):
    got = trace.range_device(params["range"])
    if got is None:
        return None
    n, _, acts = got
    return len(acts) / n if acts else None
