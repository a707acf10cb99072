"""The share of the traced window in which no operation ran on the card,
in percent."""

from vbbench import readers


def read(run):
    return readers.idle(run, "decode")
