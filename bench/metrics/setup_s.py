"""Process start to the first timed query: generation, the port's build_coo,
add_graph and the warm-up (host clock)."""


def read(run):
    return run.setup_s
