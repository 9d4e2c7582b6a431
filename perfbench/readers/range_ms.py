"""Device milliseconds per instance of a named range, every activity
launched inside it counted (``params["range"]``)."""


def read(trace, window, facts, params):
    got = trace.range_device(params["range"])
    if got is None:
        return None
    n, seconds, acts = got
    return seconds * 1e3 / n if acts else None
