"""The least bytes the slice's answers need over device busy time at the
card's HBM bandwidth."""
from bench.readers import superstep_roofline as read  # noqa: F401
