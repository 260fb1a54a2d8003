"""Shared constants of the port (``hw``)."""
