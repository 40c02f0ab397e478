"""95th percentile of the latency from the due time to the answer on the
card, over every query due in the window (host clock)."""
from bench.readers import query_p95_ms as read  # noqa: F401
