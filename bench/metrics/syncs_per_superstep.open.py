"""Host reads of device values in the superstep loops (the halt read, the
frontier's pack), counted by the program, over the supersteps of the
window's units (traced run)."""
from bench.spans import syncs_per_superstep as read  # noqa: F401
