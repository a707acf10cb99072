"""Mean wall time of the benchmark's synchronised span around
``train_tri.e_step``, an iteration."""

from vbbench import readers


def read(run):
    return readers.mean_ms(run, "estep")
