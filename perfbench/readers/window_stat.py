"""A statistic the driver took by the host clock over the run's untraced
window (``params["stat"]``, one of its end-to-end readings), for a metric
too noisy to bound end to end."""


def read(trace, window, facts, params):
    return facts.get("window", {}).get(params["stat"])
