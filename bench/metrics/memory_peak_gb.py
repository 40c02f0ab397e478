"""The card's peak of allocated memory from add_graph to the window's
close, in GB (1e9 bytes), as torch's CUDA allocator counts it: the graph
and its layouts, the result history and the answers in flight.  None
where no card was used."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
