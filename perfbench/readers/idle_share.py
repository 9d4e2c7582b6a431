"""The share of the traced window, in %, in which no device operation
ran."""


def read(trace, window, facts, params):
    if window is None or window.end <= window.start:
        return None
    busy, _ = trace.busy(window)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ((window.end - window.start) * 1e-6))
