"""Mean wall time of the benchmark's synchronised span around
``make_features`` + ``pad_features``, a request."""

from vbbench import readers


def read(run):
    return readers.mean_ms(run, "features")
