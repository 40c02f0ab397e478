"""Device busy time of the traced slice over the supersteps its units ran
(a fused group's loop once)."""
from bench.readers import device_ms_per_superstep as read  # noqa: F401
