"""Launchers of the port: ``serve``'s multi-worker aggregation helpers and
``fleet_serve`` (N replica processes behind the fault-injected fleet
coordinator)."""
