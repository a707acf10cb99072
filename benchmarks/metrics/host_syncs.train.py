"""Reads in which the host waits on the card (the program's counter
``host_sync``), an iteration."""

from vbbench import program_spans


def read(run):
    return program_spans.counter(run, "train", "host_sync")
