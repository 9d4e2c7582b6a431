"""Launchers of the port: ``serve``'s multi-worker aggregation helpers."""
