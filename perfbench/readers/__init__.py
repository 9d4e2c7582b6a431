"""Per-layer metric readers, found by the name a metric's file gives
(``metrics/<metric>.json``: ``{"reader": <module here>, ...}``).

Each module's ``read(trace, window, facts, params)`` takes the metric from
the traced window and returns a number, or None where the trace holds
nothing for it to read; the harness then leaves the metric out of the
result.  ``facts`` is the work a cell's driver counted from its shapes, by
range name."""
