"""Median of due time to dequeue, the dequeue read from the service's own
queue-wait spans (traced run)."""
from bench.readers import queue_wait_p50_ms as read  # noqa: F401
