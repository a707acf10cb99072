"""The host's own time in the lattice posteriors of the fMLLR decode (the
program's span ``fmllr.posteriors``, two a request), ms a request."""

from vbbench import program_spans


def read(run):
    return program_spans.span_ms(run, "decode", "fmllr.posteriors")
