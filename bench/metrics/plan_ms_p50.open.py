"""Median over the window's tickets of the service's plan span: the seed
lookup and the planner, host clock (traced run)."""
from bench.spans import plan_ms_p50 as read  # noqa: F401
