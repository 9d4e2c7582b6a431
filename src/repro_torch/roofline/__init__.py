"""Roofline reckoning of the port's steps (``analyzer``)."""
