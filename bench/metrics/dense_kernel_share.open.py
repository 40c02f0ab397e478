"""Share of the window's supersteps that ran through the kernel's CSR entry
of the dense superstep, counted by the program (``timeline``'s
``kernel_supersteps``) over the supersteps of the window's units (traced
run); nothing where the program counts none."""
from bench.spans import per_superstep


def read(run):
    share = per_superstep(run, "kernel_supersteps")
    return None if share is None else 100.0 * share
