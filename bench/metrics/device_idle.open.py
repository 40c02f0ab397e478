"""Share of the traced slice in which no kernel, copy or set runs on the
device."""
from bench.readers import device_idle as read  # noqa: F401
