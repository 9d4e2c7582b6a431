"""Synthetic stream sources (numpy only)."""
