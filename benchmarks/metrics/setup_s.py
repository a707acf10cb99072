"""Process start to the first timed request: the kernels' build or load,
the inputs and weights from the seed, and the warm-up."""

def read(run):
    return run.setup_s
