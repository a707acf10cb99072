"""The whole step's share of the card's peak: every layer's operations
(``counts``) at the peak of their precision, summed, over the window's wall
time, in percent."""

from vbbench import readers


def read(run):
    return readers.mfu(run, "decode")
