"""The superstep loops' span on the device, from a CUDA event at each loop's
entry to one at its exit (the program's; launch gaps and host syncs inside),
in milliseconds over the supersteps of the window's units (traced run); None
off the card."""
from bench.spans import loop_span_ms_per_superstep as read  # noqa: F401
