"""A stage's share of its roofline, in %: the least time of the work one
instance of the range needs, times its instances, over the device time
launched inside them.

The work is counted from the cell's shapes (``facts[range]``) by the
metric's terms: ``params["bytes"]`` and ``params["ops"]`` are lists of
[fact, factor], the factor a number or the name of a ``yardstick.OPS``
function of the fact ``rows``; so whatever implements the stage, the same
work is read."""
from perfbench import yardstick


def _count(terms, facts):
    total = 0.0
    for fact, factor in terms:
        if isinstance(factor, str):
            factor = yardstick.OPS[factor](facts["rows"])
        total += float(factor) * float(facts[fact])
    return total


def read(trace, window, facts, params):
    got = trace.range_device(params["range"])
    work = facts.get(params["range"])
    if got is None or work is None:
        return None
    n, seconds, _ = got
    if seconds <= 0:
        return None
    least, _ = yardstick.least_seconds(_count(params["bytes"], work),
                                       _count(params["ops"], work))
    return 100.0 * n * least / seconds

