"""Median over the window's units of the host seconds that the engine spent
building the start state and putting it on the card (the execute span's
timeline, traced run), in milliseconds."""
from bench.spans import init_ms_p50 as read  # noqa: F401
