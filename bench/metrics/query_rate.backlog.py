"""Tickets resolved in the window over the window's length (host clock)."""
from bench.readers import query_rate as read  # noqa: F401
