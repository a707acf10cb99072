"""The host's own time in ``survivor_lattices`` (the program's span
``lattice.survivors``, less its ``sync.*`` reads), ms a request."""

from vbbench import program_spans


def read(run):
    return program_spans.span_ms(run, "decode", "lattice.survivors")
