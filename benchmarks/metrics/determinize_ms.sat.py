"""The pruned determinization and best paths of the rescored lattices (the
program's span ``fmllr.determinize``), ms a request."""

from vbbench import program_spans


def read(run):
    return program_spans.span_ms(run, "decode", "fmllr.determinize", whole=True)
