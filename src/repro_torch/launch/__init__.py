"""Launchers of the port: ``serve`` (the serving CLI and its multi-worker
aggregation helpers), ``train`` (the training CLI) and ``fleet_serve``
(N replica processes behind the fault-injected fleet coordinator)."""
