"""Model FLOPs utilization, in %: the model FLOPs a step
(``facts[params["flops"]]``, counted by the driver from the cell's shapes,
``perfbench/flops.py``) times the steps of the traced window (the
instances of ``params["per"]``), over the window's length and the card's
dense bfloat16 peak (``params["peak_flops"]``)."""


def read(trace, window, facts, params):
    flops = facts.get(params["flops"])
    per = trace.spans(params["per"])
    if window is None or flops is None or not per:
        return None
    seconds = (window.end - window.start) * 1e-6
    if seconds <= 0:
        return None
    return 100.0 * flops * len(per) / seconds / float(params["peak_flops"])
