"""Reads in which the host waits on the card (the program's counter
``host_sync``: ``.cpu()`` copies and the compaction's ``torch.nonzero``),
a request."""

from vbbench import program_spans


def read(run):
    return program_spans.counter(run, "decode", "host_sync")
