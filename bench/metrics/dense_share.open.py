"""Share of the window's supersteps that the dense variant ran, from the
results' realized variant and iterations."""
from bench.readers import dense_share as read  # noqa: F401
