"""A number the driver counted on the device over the traced window and
read back after it (``facts[params["fact"]]``), such as a counter of the
program's."""


def read(trace, window, facts, params):
    value = facts.get(params["fact"])
    return None if value is None else float(value)
