"""The host's wait for each alignment sub-batch's K2 and K4 (the whole of
the program's span ``align.to_host``: its four ``sync.*`` reads), ms an
iteration."""

from vbbench import program_spans


def read(run):
    return program_spans.span_ms(run, "train", "align.to_host", whole=True)
