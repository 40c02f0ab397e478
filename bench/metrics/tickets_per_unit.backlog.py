"""Tickets resolved over units executed, from the service's counters; above
1 only where tickets fuse."""
from bench.readers import tickets_per_unit as read  # noqa: F401
